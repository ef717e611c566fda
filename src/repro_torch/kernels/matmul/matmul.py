"""MMM on Hopper: the ctypes wrapper around ``csrc/mmm.cu``.

Replaces ``repro/kernels/matmul/matmul.py::mmm_pallas``.  The kernel tiles
128x128 outputs with a shared-memory K loop and a float32 accumulator, and
masks ragged edges itself, so the wrapper pads nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("mmm")

_MAX_GRID_Y = 65535     # row tiles of 128


def mmm_problem(a, b) -> Optional[str]:
    """Why the MMM kernel cannot take ``(a, b)``, or None."""
    why = _cuda.operand_problem((a, b))
    if why:
        return why
    if a.dim() != 2 or b.dim() != 2:
        return f"MMM takes 2-D operands, got {a.dim()}-D and {b.dim()}-D"
    if a.shape[1] != b.shape[0]:
        return f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}"
    if cdiv(a.shape[0], 128) > _MAX_GRID_Y or max(*a.shape, b.shape[1]) >= 2**31:
        return f"shape {tuple(a.shape)} @ {tuple(b.shape)} exceeds the grid"
    return None


def mmm_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card, in A's type."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    rc = _cuda.lib().halo_mmm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              m, n, k, _cuda.dtype_code(a.dtype),
                              _cuda.stream(a.device))
    _cuda.check(rc, "mmm")
    LAUNCHES.add()
    return out
