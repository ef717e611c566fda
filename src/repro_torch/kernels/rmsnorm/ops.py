"""Public RMSNORM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ref import rmsnorm_ref
from .rmsnorm import rmsnorm_hopper, rmsnorm_problem


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    """RMSNorm over the last dim of x (any leading shape); gamma is (D,).

    CPU tensors take the plain version (:func:`rmsnorm_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback."""
    if x.device.type == "cpu" and gamma.device.type == "cpu":
        _cuda.require(rmsnorm_problem(x, gamma), "RMSNORM")
        return rmsnorm_ref(x, gamma, eps)
    return rmsnorm_hopper(x, gamma, eps)


def rmsnorm_supported(x, gamma, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return rmsnorm_problem(x, gamma) is None
