"""Public EWMM / EWMD / EWADD / EWSUB: the Hopper kernel for CUDA tensors,
the plain version for CPU tensors.  ``items_per_thread`` is a tuned
launch plan's (:func:`~.ewise.ewise_space`); on the CPU it is only
checked."""
from __future__ import annotations

from .. import _cuda
from .ewise import check_plan, ewise_hopper, ewise_problem
from .ref import OP_REFS


def _ewise(a, b, op, items_per_thread=None):
    if a.device.type == "cpu" and b.device.type == "cpu":
        _cuda.require(ewise_problem(a, b), f"EW {op}")
        check_plan(a, b, items_per_thread)
        return OP_REFS[op](a, b.reshape(a.shape))
    return ewise_hopper(a, b, op, items_per_thread)


def ewmm(a, b, *, items_per_thread=None):
    """Element-wise matrix multiplication, in ``a``'s shape and type."""
    return _ewise(a, b, "mul", items_per_thread)


def ewmd(a, b, *, items_per_thread=None):
    """Element-wise matrix division (IEEE), in ``a``'s shape and type."""
    return _ewise(a, b, "div", items_per_thread)


def ewadd(a, b, *, items_per_thread=None):
    """Element-wise matrix addition, in ``a``'s shape and type."""
    return _ewise(a, b, "add", items_per_thread)


def ewsub(a, b, *, items_per_thread=None):
    """Element-wise matrix subtraction, in ``a``'s shape and type."""
    return _ewise(a, b, "sub", items_per_thread)


def ewise_supported(a, b, **kw) -> bool:
    """Feasibility of the hopper rows: the kernel takes these operands."""
    return ewise_problem(a, b) is None
