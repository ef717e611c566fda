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
                               ("mvm", "mvm"), ("vdp", "vdp"))
               for f in (f"{name}.py", "ops.py")]
LIBRARY_CALLS = {"matmul", "mm", "mv", "dot", "bmm", "einsum", "mul", "div",
                 "add", "sub"}


@pytest.mark.parametrize("path", HOPPER_PATH,
                         ids=[str(p.relative_to(PKG)) for p in HOPPER_PATH])
def test_hopper_path_calls_no_library_op(path):
    """The wrappers reach the card only through the hand-written kernels:
    no torch.matmul/mv/dot/… and no ``@`` on the hopper path."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in LIBRARY_CALLS \
                and isinstance(node.value, ast.Name) and node.value.id == "torch":
            pytest.fail(f"{path.name}:{node.lineno} calls torch.{node.attr}")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            pytest.fail(f"{path.name}:{node.lineno} uses @")


@pytest.mark.parametrize("name", ["mmm", "ewise", "mvm", "vdp"])
def test_kernel_sources_carry_their_note(name):
    src = (PKG / "csrc" / f"{name}.cu").read_text()
    head = src.split("#include")[0]
    assert "Replaces src/repro/kernels/" in head
    assert "Bound on the H100" in head and "Design" in head
    assert f"extern \"C\" int halo_{name}(" in src


def test_build_flags_target_sm90a_without_fast_math():
    from repro_torch.kernels import _cuda
    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert len(_cuda.source_hash()) == 16
    assert _cuda.BUILD_ROOT.relative_to(PKG).parts == ("_build",)
