"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports JAX or the JAX package, importing it loads neither, its entry
points refuse a missing card instead of demoting to the CPU, and the hopper
path calls no library matmul."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imported_modules(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_relative_imports_stay_inside_the_package():
    for path in PKG.rglob("*.py"):
        depth = len(path.relative_to(PKG).parts) - 1     # dirs below PKG
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level - 1 <= depth, (path, node.lineno)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, torch\n"
        "import repro_torch, repro_torch.halo, repro_torch.quickstart\n"
        "import repro_torch.launch.serve, repro_torch.serve.engine\n"
        "import repro_torch.core.graph, repro_torch.core.fusion\n"
        "import repro_torch.kernels.fused, repro_torch.graph_pipeline\n"
        "import repro_torch.core.collective, repro_torch.collective_jacobi\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.remote, repro_torch.multiproc_jacobi\n"
        "import repro_torch.launch.worker\n"
        "import repro_torch.kernels as k\n"
        "from repro_torch.core.compute_object import to_numpy\n"
        "k.register_all()\n"
        "out = to_numpy(torch.ones(2, dtype=torch.bfloat16))\n"
        "assert str(out.dtype) == 'float32', out.dtype\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_initialize_without_a_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    from repro_torch import halo
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        halo.initialize()


HOPPER_PATH = [PKG / "kernels" / d / f
               for d, name in (("matmul", "matmul"), ("ewise", "ewise"),
                               ("mvm", "mvm"), ("vdp", "vdp"),
                               ("jacobi", "jacobi"), ("conv1d", "conv1d"),
                               ("spmm", "spmm"), ("fft", "fft"),
                               ("sorthist", "sorthist"), ("rmsnorm", "rmsnorm"),
                               ("flash_attention", "flash_attention"))
               for f in (f"{name}.py", "ops.py")] + [PKG / "kernels" / "fused.py"]
LIBRARY_CALLS = {"matmul", "mm", "mv", "dot", "bmm", "baddbmm", "einsum",
                 "mul", "div", "add", "sub", "conv1d", "fft", "sort",
                 "argsort", "msort", "histc", "bincount", "rms_norm",
                 "scaled_dot_product_attention", "softmax"}


#: matrix products a tensor offers as methods (``g.matmul(b)``)
PRODUCT_METHODS = {"matmul", "mm", "bmm", "mv", "dot", "baddbmm", "addmm", "einsum"}


@pytest.mark.parametrize("path", HOPPER_PATH,
                         ids=[str(p.relative_to(PKG)) for p in HOPPER_PATH])
def test_hopper_path_calls_no_library_op(path):
    """The wrappers reach the card only through the hand-written kernels:
    no torch.matmul/mv/dot/fft/sort/histc/…, no matrix-product method of a
    tensor and no ``@`` on the hopper path.  That covers the backward of
    MMM's autograd Function (``matmul/ops.py``), whose dA and dB are two
    more MMMs."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in LIBRARY_CALLS \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("torch", "F"):
            pytest.fail(f"{path.name}:{node.lineno} calls torch.{node.attr}")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in PRODUCT_METHODS:
            pytest.fail(f"{path.name}:{node.lineno} calls .{node.func.attr}()")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            pytest.fail(f"{path.name}:{node.lineno} uses @")


def test_mmm_backward_reaches_the_kernel_through_mmm(monkeypatch):
    """On CPU tensors the MMM wrapper's one way to a product is its plain
    version: the forward and both backward products pass through it."""
    from repro_torch.kernels.matmul import ops
    calls = []
    orig = ops.mmm_ref

    def counted(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return orig(a, b)
    monkeypatch.setattr(ops, "mmm_ref", counted)
    a = torch.randn(6, 5, requires_grad=True)
    b = torch.randn(5, 3, requires_grad=True)
    ops.mmm(a, b).sum().backward()
    assert calls == [((6, 5), (5, 3)), ((6, 3), (3, 5)), ((5, 6), (6, 3))]


@pytest.mark.parametrize("alias", ["MMM", "RMSNORM", "FLASH_ATTN"])
def test_hopper_rows_keep_the_graph(alias):
    """Called on tensors that require grad, the hopper row of each alias
    on the training path returns an output with a ``grad_fn``; with grad
    off it records none."""
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.kernels import register_all
    reg = KernelRegistry()
    register_all(reg)
    fn = next(r.fn for r in reg.records(alias) if r.platform == "hopper")
    args = {"MMM": ((4, 8), (8, 3)), "RMSNORM": ((2, 4, 16), (16,)),
            "FLASH_ATTN": ((1, 2, 5, 16), (1, 1, 5, 16), (1, 1, 5, 16))}[alias]
    inputs = [torch.randn(s, requires_grad=True) for s in args]
    assert fn(*inputs).grad_fn is not None
    with torch.no_grad():
        assert fn(*inputs).grad_fn is None


#: C entry point of each source whose name differs from the source's
ENTRY = {"spmm": "smmm"}


@pytest.mark.parametrize("name", ["mmm_skinny", "mmm_wgmma", "ewise", "mvm",
                                  "vdp", "jacobi", "conv1d", "spmm", "fft_chirp", "fft_radix",
                                  "sort", "sort_radix", "hist", "rmsnorm",
                                  "flash_attention_mma", "flash_attention_tf32x3",
                                  "flash_attention_wgmma", "fused"])
def test_kernel_sources_carry_their_note(name):
    src = (PKG / "csrc" / f"{name}.cu").read_text()
    head = src.split("#include")[0]
    assert "Replaces src/repro/kernels/" in head
    assert "Bound on the H100" in head and "Design" in head
    assert f"extern \"C\" int halo_{ENTRY.get(name, name)}(" in src


def test_build_flags_target_sm90a_without_fast_math():
    from repro_torch.kernels import _cuda
    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert len(_cuda.source_hash()) == 16
    assert _cuda.BUILD_ROOT.relative_to(PKG).parts == ("_build",)


@pytest.mark.parametrize("module", [
    "repro_torch.core.c2mpi", "repro_torch.kernels.staging",
    "repro_torch.core.fusion", "repro_torch.core.graph",
    "repro_torch.core.registry", "repro_torch.core.scheduler",
    "repro_torch.kernels.fused", "repro_torch.halo",
    "repro_torch.distributed.remote"])
def test_public_api_has_docstrings(module):
    """As tests/test_docstrings.py asks of the reference's core modules:
    ``__all__`` resolves and every function or class in it has a one-line
    docstring summary."""
    import importlib
    import inspect
    mod = importlib.import_module(module)
    assert getattr(mod, "__all__", None), f"{module}: no __all__"
    for sym in mod.__all__:
        obj = getattr(mod, sym)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            doc = inspect.getdoc(obj)
            assert doc and doc.strip().splitlines()[0].strip(), f"{module}.{sym}"
