"""Public VDP: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ref import vdp_ref
from .vdp import vdp_hopper, vdp_problem


def vdp(x, y):
    """Dot product of two 1-D vectors, float32 accumulation: a 0-d float32
    tensor."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        _cuda.require(vdp_problem(x, y), "VDP")
        return vdp_ref(x, y)
    return vdp_hopper(x, y)


def vdp_supported(x, y, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return vdp_problem(x, y) is None
