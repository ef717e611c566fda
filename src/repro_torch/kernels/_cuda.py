"""Build, load and launch the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled at first use, one ``nvcc`` per source started
together, for ``sm_90a`` with a plain C interface, and linked into one
shared library that is loaded with :mod:`ctypes`.  The library lands in
``repro_torch/_build/<hash>/``, keyed by a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream (PyTorch's current stream), and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.  No
``--use_fast_math``: EWMD stays an IEEE division.

Each kernel wrapper owns a :class:`LaunchCounter` and adds one to it where
it launches its kernel, so a run can show that its requests reached the
kernels (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

__all__ = ["BUILD_ROOT", "CSRC", "LaunchCounter", "NVCC_FLAGS", "aligned",
           "build", "check", "counter", "dtype_code", "launch_counts", "lib",
           "operand_problem", "require", "require_cuda", "reset_launch_counts",
           "source_hash", "stream"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libhalo_kernels.so"

#: the types every kernel takes, with their code in the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # a, b, c, m, n, k, dtype, stream
    "halo_mmm": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # a, b, out, n, op, dtype, vec, stream
    "halo_ewise": [_vp, _vp, _vp, _ll, _int, _int, _int, _vp],
    # a, x, y, m, k, dtype, vec, stream
    "halo_mvm": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # x, y, partials, out, n, nparts, dtype, vec, stream
    "halo_vdp": [_vp, _vp, _vp, _vp, _ll, _int, _int, _int, _vp],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------
class LaunchCounter:
    """Number of launches of one kernel; its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The launch counter of kernel ``name`` (created on first request)."""
    with _lock:
        return _COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    with _lock:
        return {n: c.count for n, c in sorted(_COUNTERS.items())}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _lock:
        counters = list(_COUNTERS.values())
    for c in counters:
        c.reset()


# ---------------------------------------------------------------------------
# Operand checks shared by the wrappers
# ---------------------------------------------------------------------------
def operand_problem(tensors: Sequence) -> Optional[str]:
    """Why the kernels cannot take these operands, or None.

    They must be contiguous tensors of one type (float32, bfloat16 or
    float16), all on the CPU (where the wrappers run the plain version) or
    all on one CUDA device of capability 9.0 or higher."""
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        return "operands must be tensors"
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        return f"operands must share one of float32/bfloat16/float16, got {dtypes}"
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        return f"operands lie on different devices {devices}"
    dev = next(iter(devices))
    if dev.type == "cuda":
        if torch.cuda.get_device_capability(dev) < (9, 0):
            return (f"{torch.cuda.get_device_name(dev)} is below CUDA "
                    f"capability 9.0")
    elif dev.type != "cpu":
        return f"unsupported device {dev}"
    if not all(t.is_contiguous() for t in tensors):
        return "operands must be contiguous"
    return None


def require(problem: Optional[str], what: str) -> None:
    """Raise ``ValueError`` naming ``what`` when ``problem`` is set."""
    if problem:
        raise ValueError(f"{what}: {problem}")


def require_cuda(problem: Optional[str], what: str, t: torch.Tensor) -> None:
    """As :func:`require`, and the operands must lie on the card."""
    require(problem, what)
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the Hopper kernel takes CUDA tensors, "
                         f"got {t.device}")


def dtype_code(dtype: torch.dtype) -> int:
    return _DTYPE_CODES[dtype]


def aligned(*tensors: torch.Tensor) -> bool:
    """True when every data pointer allows 16-byte vector loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Build + load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the Hopper kernels "
                       "are built from csrc/ at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every kernel source, header and compiler flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link one
    shared library; returns its path.  Reuses an earlier build of the same
    sources.  The compiler's output, ``-Xptxas -v`` register and shared
    memory counts included, is kept in ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.is_file():
        return so
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        cus, _ = _sources()
        procs = []
        for src in cus:
            log = open(tmp / f"{src.stem}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(tmp / f"{src.stem}.o")]
            procs.append((src, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{src.name}:\n"
                              + (tmp / f"{src.stem}.log").read_text())
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / f"{s.stem}.o") for s in cus]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        (tmp / "build.log").write_text("".join(
            (tmp / f"{s.stem}.log").read_text() for s in cus))
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not so.is_file():   # not a concurrent build that won the race
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.halo_error_string.argtypes = [ctypes.c_int]
            handle.halo_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().halo_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
