"""FLASH_ATTN on Hopper: the ctypes wrappers around
``csrc/flash_attention_tf32x3.cu``, ``csrc/flash_attention_mma.cu`` and
``csrc/flash_attention_wgmma.cu``, and the route between them.

Replaces ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``.  Online-softmax GQA attention, one block per
(b, h, query tile) that loops over KV tiles staged in shared memory.  The
kernels are instantiated at the head dims of :data:`HEAD_DIMS`; any other
head dim up to 256 is zero-padded in q, k and v to the next one
(:func:`padded_head_dim`: MLA's 192 → 256, the reduced MLA's 48 → 64),
which leaves q·kᵀ as it was, and the output is sliced back.  The scale is
always D^-1/2 of the real head dim.  The reference pads the same way, to
a multiple of 128.  Three routes, chosen by type and (padded) head dim
alone (:func:`fa_route`):

* ``tf32x3`` (``flash_attention_tf32x3.cu``), float32 at every head dim of
  :data:`HEAD_DIMS`: both products on the tensor cores (wgmma) by 3×TF32,
  each operand split into TF32 hi + lo and each product lo·hi + hi·lo +
  hi·hi, each 32-deep block of q·kᵀ and each 32 keys of p·v in a fresh
  accumulator added in float32.  A split pass first writes each key tile
  of k and v, split and laid out as the product kernel stages it, into a
  workspace the wrapper allocates (:func:`tf32x3_workspace_bytes`);
* ``mma`` (``flash_attention_mma.cu``), bfloat16 and float16 at head dims
  :data:`MMA_HEAD_DIMS`: both products on the tensor cores (mma.sync, float32
  accumulators), p rounded to the input type in registers, K/V tiles in a
  cp.async ring;
* ``wgmma`` (``flash_attention_wgmma.cu``), bfloat16 and float16 at head
  dim :data:`WGMMA_HEAD_DIM`: both products on wgmma, p rounded to the input
  type in registers as on the mma route, q and a two-stage K/V ring loaded
  by TMA from a producer warp.  Operands off the 16-byte grid are first
  copied into a workspace the wrapper allocates
  (:func:`wgmma_workspace_bytes`).

Each route counts its own launches (``flash_attention_tf32x3``,
``flash_attention_mma`` and ``flash_attention_wgmma``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _cuda

MMA_LAUNCHES = _cuda.counter("flash_attention_mma")
TF32X3_LAUNCHES = _cuda.counter("flash_attention_tf32x3")
WGMMA_LAUNCHES = _cuda.counter("flash_attention_wgmma")

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: head dims of the mma route: multiples of 16 up to 128
MMA_HEAD_DIMS = (32, 64, 80, 96, 128)
#: the head dim of the wgmma route (gemma-7b's and gemma3-4b's)
WGMMA_HEAD_DIM = 256


def padded_head_dim(d: int) -> int:
    """The smallest head dim of :data:`HEAD_DIMS` that holds ``d`` (at most
    256): the width the kernels run ``d`` at."""
    return min(x for x in HEAD_DIMS if x >= d)


def fa_route(dtype: torch.dtype, d: int) -> str:
    """``"tf32x3"`` for float32, ``"mma"`` for bfloat16 and float16 at a head
    dim that pads to one of :data:`MMA_HEAD_DIMS`, ``"wgmma"`` for them at
    one that pads to :data:`WGMMA_HEAD_DIM`."""
    if dtype == torch.float32:
        return "tf32x3"
    return "mma" if padded_head_dim(d) in MMA_HEAD_DIMS else "wgmma"


def tf32x3_key_tile(d: int) -> int:
    """Keys per tile of the tf32x3 kernel at head dim ``d`` (its ``WGeom``):
    64 up to d = 96, 32 above, where q's hi and lo planes and one key
    tile's fill the shared memory."""
    return 64 if d <= 96 else 32


def tf32x3_workspace_bytes(b: int, hkv: int, skv: int, d: int) -> int:
    """Bytes of the split key tiles the tf32x3 kernel stages from, for
    k, v (b, hkv, skv, d): per KV head and key tile, k's and vᵀ's TF32 hi
    and lo planes (k in 32-float column blocks of 128-byte rows, vᵀ in
    blocks of 32 keys), as the kernel's split pass writes them."""
    tile = tf32x3_key_tile(d)
    blocks = -(-d // 32)
    tile_bytes = 2 * (tile * blocks * 128 + d * (tile // 32) * 128)
    return b * hkv * -(-skv // tile) * tile_bytes


def wgmma_workspace_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Bytes of the aligned copies the wgmma route makes first: TMA loads
    from a 16-byte base only, so each of q, k and v whose data lies off the
    16-byte grid is copied whole (its rows of 512 bytes keep every stride
    on the grid)."""
    return sum(t.numel() * t.element_size() for t in (q, k, v) if t.data_ptr() % 16)


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
    if not 0 < d <= HEAD_DIMS[-1]:
        return f"head dim {d} is not within 1..{HEAD_DIMS[-1]}"
    if skv == 0:
        return "no keys"
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ or max(sq, skv) >= 2**31:
        return f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the grid"
    return None


def _launch(route, q, k, v, causal, window, prefix_len):
    scale = float(q.shape[-1] ** -0.5)          # the real head dim's
    dp = padded_head_dim(q.shape[-1])
    if dp != q.shape[-1]:
        pad = (0, dp - q.shape[-1])
        out = _launch_at(route, F.pad(q, pad), F.pad(k, pad), F.pad(v, pad),
                         causal, window, prefix_len, scale)
        return out[..., :q.shape[-1]].contiguous()
    return _launch_at(route, q, k, v, causal, window, prefix_len, scale)


def _launch_at(route, q, k, v, causal, window, prefix_len, scale):
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    rest = (b, h, k.shape[1], sq, k.shape[2], d, int(causal), int(window is not None),
            int(window or 0), int(prefix_len), scale, _cuda.dtype_code(q.dtype))
    args = ptrs + rest
    if route == "tf32x3":
        ws_bytes = tf32x3_workspace_bytes(b, k.shape[1], k.shape[2], d)
        ws = torch.empty(max(ws_bytes, 16), dtype=torch.uint8, device=q.device)
        rc = _cuda.lib().halo_flash_attention_tf32x3(
            *ptrs, ws.data_ptr(), ws_bytes, *rest, int(_cuda.aligned(q, k, v)),
            _cuda.stream(q.device))
        _cuda.check(rc, "flash_attention_tf32x3")
        TF32X3_LAUNCHES.add()
    elif route == "mma":
        rc = _cuda.lib().halo_flash_attention_mma(
            *args, int(_cuda.aligned(q, k, v)), _cuda.stream(q.device))
        _cuda.check(rc, "flash_attention_mma")
        MMA_LAUNCHES.add()
    else:
        ws_bytes = wgmma_workspace_bytes(q, k, v)
        ws = torch.empty(max(ws_bytes, 16), dtype=torch.uint8, device=q.device)
        rc = _cuda.lib().halo_flash_attention_wgmma(
            *ptrs, ws.data_ptr(), ws_bytes, *rest, _cuda.stream(q.device))
        _cuda.check(rc, "flash_attention_wgmma")
        WGMMA_LAUNCHES.add()
    return out


def flash_attention_mma_hopper(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, causal: bool = True, window: Optional[int] = None,
                               prefix_len: int = 0) -> torch.Tensor:
    """Attention of q over k, v on the card by the tensor-core kernel
    (bfloat16 or float16, a head dim that pads to one of
    :data:`MMA_HEAD_DIMS`), in q's type."""
    _cuda.require_cuda(flash_attention_problem(q, k, v), "FLASH_ATTN", q)
    if fa_route(q.dtype, q.shape[-1]) != "mma":
        raise ValueError(f"FLASH_ATTN: the mma route takes bfloat16 or float16 at "
                         f"head dims {MMA_HEAD_DIMS}, got {q.dtype}, "
                         f"{q.shape[-1]}")
    return _launch("mma", q, k, v, causal, window, prefix_len)


def flash_attention_wgmma_hopper(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  prefix_len: int = 0) -> torch.Tensor:
    """Attention of q over k, v on the card by the wgmma kernel (bfloat16 or
    float16 at a head dim that pads to :data:`WGMMA_HEAD_DIM`), in q's
    type."""
    _cuda.require_cuda(flash_attention_problem(q, k, v), "FLASH_ATTN", q)
    if fa_route(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"FLASH_ATTN: the wgmma route takes bfloat16 or float16 at "
                         f"head dim {WGMMA_HEAD_DIM}, got {q.dtype}, {q.shape[-1]}")
    return _launch("wgmma", q, k, v, causal, window, prefix_len)


def flash_attention_tf32x3_hopper(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  prefix_len: int = 0) -> torch.Tensor:
    """Attention of float32 q over k, v on the card by the 3×TF32
    tensor-core kernel (any head dim up to 256, padded to one of
    :data:`HEAD_DIMS`), in float32."""
    _cuda.require_cuda(flash_attention_problem(q, k, v), "FLASH_ATTN", q)
    if q.dtype != torch.float32:
        raise ValueError(f"FLASH_ATTN: the tf32x3 route takes float32, got {q.dtype}")
    return _launch("tf32x3", q, k, v, causal, window, prefix_len)


def flash_attention_hopper(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: Optional[int] = None,
                           prefix_len: int = 0) -> torch.Tensor:
    """Attention of q over k, v on the card, in q's type, by the route
    :func:`fa_route` picks for its type and head dim."""
    _cuda.require_cuda(flash_attention_problem(q, k, v), "FLASH_ATTN", q)
    return _launch(fa_route(q.dtype, q.shape[-1]), q, k, v, causal, window,
                   prefix_len)
