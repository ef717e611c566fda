"""Public MMM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors; differentiable, with two more MMMs as its backward.  A tuned
launch plan (``route``, ``splits``, ``tile_n``: :func:`~.matmul.mmm_space`)
reaches the forward's kernel; on the CPU it is only checked."""
from __future__ import annotations

import torch

from .. import _cuda
from .matmul import check_plan, mmm_hopper, mmm_problem
from .ref import mmm_ref


def _mmm(a, b, plan=None):
    plan = plan or {}
    if a.device.type == "cpu" and b.device.type == "cpu":
        _cuda.require(mmm_problem(a, b), "MMM")
        check_plan(a, b, plan)
        return mmm_ref(a, b)
    return mmm_hopper(a, b, **plan)


class MMMFunction(torch.autograd.Function):
    """C = A·B whose backward is two more MMMs, dA = g·Bᵀ and dB = Aᵀ·g,
    each cast to its operand's type: the kernel is its own gradient engine
    (the reference's ``_mmm_diff``).  The transposes are made contiguous
    first, since the kernels take contiguous operands.  ``plan`` is the
    forward's launch plan; the backward's two MMMs take the default plan
    at their own shapes."""

    @staticmethod
    def forward(ctx, a, b, plan=None):
        ctx.save_for_backward(a, b)
        return _mmm(a, b, plan)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mmm(g, b.t().contiguous()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mmm(a.t().contiguous(), g).to(b.dtype)
        return da, db, None


def mmm(a, b, *, route=None, splits=None, tile_n=None):
    """Hardware-adapted MMM: float32 accumulation, result in A's type.

    CPU tensors take the plain version (:func:`mmm_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback.
    ``route``, ``splits`` and ``tile_n`` set the launch plan (a TuningDB
    entry's, :func:`~.matmul.mmm_space`; a plan outside the space raises,
    on the CPU too).  With grad enabled and an operand that requires it,
    the call goes through :class:`MMMFunction`."""
    plan = {k: v for k, v in (("route", route), ("splits", splits),
                               ("tile_n", tile_n)) if v is not None}
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return MMMFunction.apply(a, b, plan)
    return _mmm(a, b, plan)


def mmm_supported(a, b, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return mmm_problem(a, b) is None
