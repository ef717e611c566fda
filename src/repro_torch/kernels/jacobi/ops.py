"""Public JS: the Hopper kernel for CUDA tensors, the plain version for CPU
tensors."""
from __future__ import annotations

import torch

from .. import _cuda
from .jacobi import jacobi_hopper, jacobi_problem
from .ref import jacobi_step_ref


def jacobi_step(a, x, b):
    """One fused Jacobi sweep for Ax = b (square A), in x's type."""
    if all(t.device.type == "cpu" for t in (a, x, b)):
        _cuda.require(jacobi_problem(a, x, b), "JS")
        return jacobi_step_ref(a, x, b)
    return jacobi_hopper(a, x, b)


def jacobi_solve(a, b, iters: int = 20, x0=None):
    """``iters`` fused sweeps from ``x0`` (zeros), each on the device that
    holds the operands; nothing returns to the host between sweeps."""
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iters):
        x = jacobi_step(a, x, b)
    return x


def jacobi_supported(a, x, b, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return jacobi_problem(a, x, b) is None
