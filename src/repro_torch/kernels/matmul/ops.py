"""Public MMM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .matmul import mmm_hopper, mmm_problem
from .ref import mmm_ref


def mmm(a, b):
    """Hardware-adapted MMM: float32 accumulation, result in A's type.

    CPU tensors take the plain version (:func:`mmm_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        _cuda.require(mmm_problem(a, b), "MMM")
        return mmm_ref(a, b)
    return mmm_hopper(a, b)


def mmm_supported(a, b, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return mmm_problem(a, b) is None
