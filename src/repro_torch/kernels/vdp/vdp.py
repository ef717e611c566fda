"""VDP on Hopper: the ctypes wrapper around ``csrc/vdp.cu``.

Replaces ``repro/kernels/vdp/vdp.py::vdp_pallas``.  Two passes without
atomics: per-block float32 partials over a fixed grid, then one block sums
them in a fixed order, so the result has the same bits run to run.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("vdp")

#: most pass-1 blocks; fixed per input size so the summation order is too
MAX_PARTS = 1024
_THREADS = 256


def vdp_problem(x, y) -> Optional[str]:
    """Why the VDP kernel cannot take ``(x, y)``, or None."""
    why = _cuda.operand_problem((x, y))
    if why:
        return why
    if x.dim() != 1 or y.dim() != 1 or x.shape != y.shape:
        return (f"VDP takes two 1-D vectors of one length, got "
                f"{tuple(x.shape)} and {tuple(y.shape)}")
    return None


def vdp_parts(n: int, element_size: int) -> int:
    """Pass-1 block count: one 16-byte vector per thread per block at
    least, at most :data:`MAX_PARTS`."""
    per_block = _THREADS * (16 // element_size)
    return max(1, min(MAX_PARTS, cdiv(n, per_block)))


def vdp_hopper(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ x·y on the card: a 0-d float32 tensor."""
    _cuda.require_cuda(vdp_problem(x, y), "VDP", x)
    n = x.numel()
    nparts = vdp_parts(n, x.element_size())
    partials = torch.empty((nparts,), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().halo_vdp(x.data_ptr(), y.data_ptr(), partials.data_ptr(),
                              out.data_ptr(), n, nparts,
                              _cuda.dtype_code(x.dtype), int(_cuda.aligned(x, y)),
                              _cuda.stream(x.device))
    _cuda.check(rc, "vdp")
    LAUNCHES.add()
    return out
