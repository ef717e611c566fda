"""Public MVM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .mvm import mvm_hopper, mvm_problem
from .ref import mvm_ref


def mvm(a, x):
    """y = A @ x for A (M,K), x (K,), float32 accumulation, in A's type."""
    if a.device.type == "cpu" and x.device.type == "cpu":
        _cuda.require(mvm_problem(a, x), "MVM")
        return mvm_ref(a, x)
    return mvm_hopper(a, x)


def mvm_supported(a, x, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return mvm_problem(a, x) is None
