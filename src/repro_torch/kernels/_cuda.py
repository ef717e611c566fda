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
kernels (:func:`launch_counts`).  A CUDA graph replays launches without
their wrappers: :func:`recording_launches` notes what a capture launched,
and the replaying code credits it to the counters on every replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import torch

__all__ = ["BUILD_ROOT", "CSRC", "LaunchCounter", "NVCC_FLAGS", "aligned",
           "build", "check", "counter", "credit_launches", "dtype_code",
           "index_problem", "launch_counts", "lib", "operand_problem",
           "recording_launches", "require", "require_cuda",
           "reset_launch_counts", "sm_count", "source_hash", "stream"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libhalo_kernels.so"

#: the types every kernel takes, with their code in the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_vp, _int, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # a, b, c, ws, m, n, k, bn, pack_a, pack_b, dtype, stream (bfloat16 or
    # float16)
    "halo_mmm_wgmma": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int, _vp],
    # a, b, c, ws, m, n, k, stream (float32)
    "halo_mmm_tf32x3": [_vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # a, b, c, ws, m, n, k, splits, kb, kw, vec, dtype, stream
    "halo_mmm_skinny": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int,
                        _int, _int, _vp],
    # a, b, out, n, op, dtype, vec, items_per_thread, blocks, stream
    "halo_ewise": [_vp, _vp, _vp, _ll, _int, _int, _int, _int, _ll, _vp],
    # a, x, y, m, k, dtype, vec, stream
    "halo_mvm": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # x, y, partials, out, n, nparts, dtype, vec, stream
    "halo_vdp": [_vp, _vp, _vp, _vp, _ll, _int, _int, _int, _vp],
    # a, x, b, out, n, dtype, vec, stream
    "halo_jacobi": [_vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # x, w, out, n, k, dtype, stream
    "halo_conv1d": [_vp, _vp, _vp, _ll, _ll, _int, _vp],
    # values, indices, b, c, ws, nrows, S, bm, bk, k, n, dtype, stream
    "halo_smmm": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _int, _vp],
    # x, chirp, spectrum, tw, out, m, n, dtype, stream
    "halo_fft_chirp": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _vp],
    # x, tw, out, m, n, vec, dtype, stream
    "halo_fft_radix": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # x, out, rows, n, keys_per_thread, threads_per_row, rows_per_block,
    # blocks, dtype, vec, stream
    "halo_sort": [_vp, _vp, _ll, _ll, _int, _int, _int, _ll, _int, _int, _vp],
    # x, out, keys, keys_len, tables, tables_len, rows, n, dtype, stream
    "halo_sort_radix": [_vp, _vp, _vp, _ll, _vp, _ll, _ll, _ll, _int, _vp],
    # x, counts, out, n, bins, lo, hi, width, dtype, stream
    "halo_hist": [_vp, _vp, _vp, _ll, _int, _f, _f, _f, _int, _vp],
    # x, gamma, out, rows, d, eps, dtype, vec, warps_per_row, vecs, blocks,
    # stream
    "halo_rmsnorm": [_vp, _vp, _vp, _int, _int, _f, _int, _int, _int, _int, _int, _vp],
    # q, k, v, out, b, h, hkv, sq, skv, d, causal, has_window, window,
    # prefix, scale, dtype, vec, stream (bfloat16 or float16, d <= 128)
    "halo_flash_attention_mma": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                                 _int, _int, _int, _int, _int, _f, _int, _int, _vp],
    # q, k, v, out, ws, ws_bytes, then as halo_flash_attention_mma (float32
    # only)
    "halo_flash_attention_tf32x3": [_vp, _vp, _vp, _vp, _vp, _ll, _int, _int, _int, _int,
                                    _int, _int, _int, _int, _int, _int, _f, _int, _int,
                                    _vp],
    # q, k, v, out, ws, ws_bytes, then as halo_flash_attention_mma without
    # vec (bfloat16 or float16 at d = 256; ws takes the aligned copies)
    "halo_flash_attention_wgmma": [_vp, _vp, _vp, _vp, _vp, _ll, _int, _int, _int, _int,
                                   _int, _int, _int, _int, _int, _int, _f, _int, _vp],
    # g, perm, sorted_tok, bounds, partial, out, n, d, vocab, dtype, stream
    "halo_embed_grad": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # inputs (void* array), n_in, steps (int array), n_steps, out, n, dtype,
    # vec, stream
    "halo_fused": [ctypes.POINTER(_vp), _int, ctypes.POINTER(_int), _int, _vp,
                   _ll, _int, _int, _vp],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------
_recording = threading.local()


class LaunchCounter:
    """Number of launches of one kernel; its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
        noted = getattr(_recording, "counts", None)
        if noted is not None:
            noted[self] = noted.get(self, 0) + n

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


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[LaunchCounter, int]]:
    """Note every launch this thread's wrappers count inside the block:
    yields {counter: launches}, filled as they launch (a CUDA graph's
    capture, whose launches a replay repeats without the wrappers)."""
    outer = getattr(_recording, "counts", None)
    noted: Dict[LaunchCounter, int] = {}
    _recording.counts = noted
    try:
        yield noted
    finally:
        _recording.counts = outer
        if outer is not None:
            for c, n in noted.items():
                outer[c] = outer.get(c, 0) + n


def credit_launches(noted: Dict[LaunchCounter, int]) -> None:
    """Add launches noted by :func:`recording_launches` to their counters
    (one replay of what was recorded)."""
    for c, n in noted.items():
        c.add(n)


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


def index_problem(index, like: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot take ``index`` as the int32 index table beside
    the float operand ``like``, or None: a contiguous int32 tensor on
    ``like``'s device."""
    if not isinstance(index, torch.Tensor):
        return "the index table must be a tensor"
    if index.dtype != torch.int32:
        return f"the index table must be int32, got {index.dtype}"
    if index.device != like.device:
        return (f"the index table lies on {index.device}, the operands on "
                f"{like.device}")
    if not index.is_contiguous():
        return "the index table must be contiguous"
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


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read from the device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
