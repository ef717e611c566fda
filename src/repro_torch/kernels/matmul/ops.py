"""Public MMM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors; differentiable, with two more MMMs as its backward."""
from __future__ import annotations

import torch

from .. import _cuda
from .matmul import mmm_hopper, mmm_problem
from .ref import mmm_ref


def _mmm(a, b):
    if a.device.type == "cpu" and b.device.type == "cpu":
        _cuda.require(mmm_problem(a, b), "MMM")
        return mmm_ref(a, b)
    return mmm_hopper(a, b)


class MMMFunction(torch.autograd.Function):
    """C = A·B whose backward is two more MMMs, dA = g·Bᵀ and dB = Aᵀ·g,
    each cast to its operand's type: the kernel is its own gradient engine
    (the reference's ``_mmm_diff``).  The transposes are made contiguous
    first, since the kernels take contiguous operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mmm(g, b.t().contiguous()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mmm(a.t().contiguous(), g).to(b.dtype)
        return da, db


def mmm(a, b):
    """Hardware-adapted MMM: float32 accumulation, result in A's type.

    CPU tensors take the plain version (:func:`mmm_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback.  With
    grad enabled and an operand that requires it, the call goes through
    :class:`MMMFunction`."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return MMMFunction.apply(a, b)
    return _mmm(a, b)


def mmm_supported(a, b, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return mmm_problem(a, b) is None
