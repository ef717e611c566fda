"""Public EWMM / EWMD / EWADD / EWSUB: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ewise import ewise_hopper, ewise_problem
from .ref import OP_REFS


def _ewise(a, b, op):
    if a.device.type == "cpu" and b.device.type == "cpu":
        _cuda.require(ewise_problem(a, b), f"EW {op}")
        return OP_REFS[op](a, b.reshape(a.shape))
    return ewise_hopper(a, b, op)


def ewmm(a, b):
    """Element-wise matrix multiplication, in ``a``'s shape and type."""
    return _ewise(a, b, "mul")


def ewmd(a, b):
    """Element-wise matrix division (IEEE), in ``a``'s shape and type."""
    return _ewise(a, b, "div")


def ewadd(a, b):
    """Element-wise matrix addition, in ``a``'s shape and type."""
    return _ewise(a, b, "add")


def ewsub(a, b):
    """Element-wise matrix subtraction, in ``a``'s shape and type."""
    return _ewise(a, b, "sub")


def ewise_supported(a, b, **kw) -> bool:
    """Feasibility of the hopper rows: the kernel takes these operands."""
    return ewise_problem(a, b) is None
