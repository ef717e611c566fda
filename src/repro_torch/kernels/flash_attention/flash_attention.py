"""FLASH_ATTN on Hopper: the ctypes wrapper around
``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``.  Online-softmax GQA attention, one block per
(b, h, 64 query rows), KV tiles staged in shared memory; nothing is padded
and the scale is D^-1/2 of the real head dim.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("flash_attention")

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 96, 128, 256)

_MAX_GRID_YZ = 65535


def flash_attention_problem(q, k, v) -> Optional[str]:
    """Why the FLASH_ATTN kernel cannot take ``(q, k, v)``, or None."""
    why = _cuda.operand_problem((q, k, v))
    if why:
        return why
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return "FLASH_ATTN takes q (B,H,Sq,D) and k, v (B,Hkv,Skv,D)"
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        return (f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                f"q {tuple(q.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        return f"{h} query heads do not split over {hkv} KV heads"
    if d not in HEAD_DIMS:
        return f"head dim {d} is not one of {HEAD_DIMS}"
    if skv == 0:
        return "no keys"
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ or max(sq, skv) >= 2**31:
        return f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the grid"
    return None


def flash_attention_hopper(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: Optional[int] = None,
                           prefix_len: int = 0) -> torch.Tensor:
    """Attention of q over k, v on the card, in q's type."""
    _cuda.require_cuda(flash_attention_problem(q, k, v), "FLASH_ATTN", q)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _cuda.lib().halo_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        k.shape[1], sq, k.shape[2], d, int(causal), int(window is not None),
        int(window or 0), int(prefix_len), float(d ** -0.5),
        _cuda.dtype_code(q.dtype), _cuda.stream(q.device))
    _cuda.check(rc, "flash_attention")
    LAUNCHES.add()
    return out
