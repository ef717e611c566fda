"""Public 1DCONV: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .conv1d import conv1d_hopper, conv1d_problem
from .ref import conv1d_ref


def conv1d(x, w):
    """Valid 1-D cross-correlation of signal ``x`` (N,) with taps ``w``
    (K ≤ N): (N − K + 1,) in x's type, float32 accumulation."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        _cuda.require(conv1d_problem(x, w), "1DCONV")
        return conv1d_ref(x, w)
    return conv1d_hopper(x, w)


def conv1d_supported(x, w, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return conv1d_problem(x, w) is None
