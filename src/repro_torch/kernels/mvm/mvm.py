"""MVM on Hopper: the ctypes wrapper around ``csrc/mvm.cu``.

Replaces ``repro/kernels/mvm/mvm.py::mvm_pallas``.  One warp per row with
coalesced 16-byte loads and a warp-shuffle reduction in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("mvm")


def mvm_problem(a, x) -> Optional[str]:
    """Why the MVM kernel cannot take ``(a, x)``, or None."""
    why = _cuda.operand_problem((a, x))
    if why:
        return why
    if a.dim() != 2 or x.dim() != 1:
        return f"MVM takes A (M,K) and x (K,), got {a.dim()}-D and {x.dim()}-D"
    if a.shape[1] != x.shape[0]:
        return f"inner dimensions differ: {tuple(a.shape)} @ {tuple(x.shape)}"
    if max(a.shape) >= 2**31:
        return f"shape {tuple(a.shape)} exceeds the kernel's int indices"
    return None


def mvm_hopper(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ x (K,) → y (M,) on the card, in A's type."""
    _cuda.require_cuda(mvm_problem(a, x), "MVM", a)
    m, k = a.shape
    y = torch.empty((m,), dtype=a.dtype, device=a.device)
    if m == 0:
        return y
    vec = _cuda.aligned(a, x) and (k * a.element_size()) % 16 == 0
    rc = _cuda.lib().halo_mvm(a.data_ptr(), x.data_ptr(), y.data_ptr(), m, k,
                              _cuda.dtype_code(a.dtype), int(vec),
                              _cuda.stream(a.device))
    _cuda.check(rc, "mvm")
    LAUNCHES.add()
    return y
