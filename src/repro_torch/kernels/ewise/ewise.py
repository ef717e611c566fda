"""EW* on Hopper: the ctypes wrapper around ``csrc/ewise.cu``.

Replaces ``repro/kernels/ewise/ewise.py::ewise_pallas``.  One grid-stride
kernel per (type, op) over the flat operands, with 16-byte vector loads
where aligned; the ragged edge is masked, so the divisor is never padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("ewise")

#: op name -> the code the C entry point takes
OPS = {"mul": 0, "div": 1, "add": 2, "sub": 3}


def ewise_problem(a, b) -> Optional[str]:
    """Why the EW* kernel cannot take ``(a, b)``, or None: ``b`` must have
    as many elements as ``a`` (it is read in ``a``'s shape, no
    broadcasting)."""
    why = _cuda.operand_problem((a, b))
    if why:
        return why
    if a.numel() != b.numel():
        return (f"EW* operands differ in size: {tuple(a.shape)} vs "
                f"{tuple(b.shape)} (no broadcasting)")
    return None


def ewise_hopper(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """``a (op) b`` element-wise on the card, in ``a``'s shape and type."""
    _cuda.require_cuda(ewise_problem(a, b), f"EW {op}", a)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    rc = _cuda.lib().halo_ewise(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.numel(), OPS[op], _cuda.dtype_code(a.dtype),
                                int(_cuda.aligned(a, b, out)),
                                _cuda.stream(a.device))
    _cuda.check(rc, "ewise")
    LAUNCHES.add()
    return out
