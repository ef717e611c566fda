"""Public RMSNORM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors; differentiable through the plain version's VJP.
``warps_per_row`` is a tuned launch plan's (:func:`~.rmsnorm.rmsnorm_space`);
on the CPU it is only checked."""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import rmsnorm_ref
from .rmsnorm import check_plan, rmsnorm_hopper, rmsnorm_problem


def _rmsnorm(x, gamma, eps, warps_per_row=None):
    if x.device.type == "cpu" and gamma.device.type == "cpu":
        _cuda.require(rmsnorm_problem(x, gamma), "RMSNORM")
        check_plan(x, warps_per_row)
        return rmsnorm_ref(x, gamma, eps)
    return rmsnorm_hopper(x, gamma, eps, warps_per_row)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm whose backward recomputes :func:`rmsnorm_ref` and takes its
    VJP (the reference's ``_rmsnorm_diff``: RMSNorm is memory-bound, so
    the recompute is one pass)."""

    @staticmethod
    def forward(ctx, x, gamma, eps, warps_per_row=None):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rmsnorm(x, gamma, eps, warps_per_row)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        with torch.enable_grad():
            x_, gamma_ = x.detach().requires_grad_(), gamma.detach().requires_grad_()
            out = rmsnorm_ref(x_, gamma_, ctx.eps)
            dx, dgamma = torch.autograd.grad(out, (x_, gamma_), g)
        return dx, dgamma, None, None


def rmsnorm(x, gamma, *, eps: float = 1e-6, warps_per_row=None):
    """RMSNorm over the last dim of x (any leading shape); gamma is (D,).

    CPU tensors take the plain version (:func:`rmsnorm_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback.
    ``warps_per_row`` sets the rows kernel's W (a TuningDB entry's; outside
    the space it raises, on the CPU too).  With grad enabled and an operand
    that requires it, the call goes through :class:`RMSNormFunction`."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return RMSNormFunction.apply(x, gamma, eps, warps_per_row)
    return _rmsnorm(x, gamma, eps, warps_per_row)


def rmsnorm_supported(x, gamma, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return rmsnorm_problem(x, gamma) is None
