"""RMSNORM on Hopper: the ctypes wrapper around ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas``.  One warp
per row holding the row in registers (16-byte aligned rows of up to 512
vectors) or one block per row, float32 inside; nothing is padded, so the
wrapper passes the rows as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("rmsnorm")


def rmsnorm_problem(x, gamma) -> Optional[str]:
    """Why the RMSNORM kernel cannot take ``(x, gamma)``, or None."""
    why = _cuda.operand_problem((x, gamma))
    if why:
        return why
    if x.dim() < 1 or gamma.dim() != 1:
        return (f"RMSNORM takes x (..., D) and gamma (D,), got {x.dim()}-D "
                f"and {gamma.dim()}-D")
    if x.shape[-1] != gamma.shape[0]:
        return f"gamma {tuple(gamma.shape)} does not match x {tuple(x.shape)}"
    if x.shape[-1] == 0 or x.numel() // x.shape[-1] >= 2**31 \
            or x.shape[-1] >= 2**31:
        return f"shape {tuple(x.shape)} is empty or exceeds the grid"
    return None


def rmsnorm_hopper(x: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of x over its last dim on the card, in x's type."""
    _cuda.require_cuda(rmsnorm_problem(x, gamma), "RMSNORM", x)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    vec = _cuda.aligned(x, gamma, out) and (d * x.element_size()) % 16 == 0
    rc = _cuda.lib().halo_rmsnorm(x.data_ptr(), gamma.data_ptr(),
                                  out.data_ptr(), rows, d, float(eps),
                                  _cuda.dtype_code(x.dtype), int(vec),
                                  _cuda.stream(x.device))
    _cuda.check(rc, "rmsnorm")
    LAUNCHES.add()
    return out
