"""Attention blocks: GQA/MQA (+SWA, prefix-LM) — port of
``repro.models.attention``.

Sequence-level attention (prefill) routes through the FLASH_ATTN alias;
decode-time single-query attention is inline masked einsum over the cache,
as in the reference, where it is no Pallas kernel either.  The decode path
writes each lane's new key and value into the slot cache in place.

Not ported yet: chunked prefill through the cache (``chunk_attention``,
``chunk_ring_attention``), which serves the paged engine (ROADMAP A7), and
MLA (``mla_forward``, ROADMAP A6).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import AttnConfig
from ..core.c2mpi import halo_dispatch
from ..distributed.sharding import ParamSpec, shard
from .layers import dense, rope

Params = Dict[str, torch.Tensor]

_MLA = "MLA attention (mla_forward, kv_lora > 0) is not ported yet (ROADMAP A6)"
_CHUNK = ("multi-token steps through the cache (chunk_attention, "
          "chunk_ring_attention) come with PagedEngine (ROADMAP A7)")


# ---------------------------------------------------------------------------
# Parameter planning
# ---------------------------------------------------------------------------
def attn_param_specs(d_model: int, a: AttnConfig, dtype) -> Dict[str, ParamSpec]:
    if a.kv_lora:
        raise NotImplementedError(_MLA)
    h, kv, dh = a.n_heads, a.n_kv_heads, a.head_dim
    return {
        "wq": ParamSpec((d_model, h * dh), dtype, ("fsdp", "tp")),
        "wk": ParamSpec((d_model, kv * dh), dtype, ("fsdp", "tp")),
        "wv": ParamSpec((d_model, kv * dh), dtype, ("fsdp", "tp")),
        "wo": ParamSpec((h * dh, d_model), dtype, ("tp", "fsdp")),
    }


# ---------------------------------------------------------------------------
# GQA forward (sequence + decode)
# ---------------------------------------------------------------------------
def _split_heads(x, n, dh):
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh)


def _lane_positions(pos, b: int, device) -> torch.Tensor:
    """Normalize a decode cache position to a per-lane (B,) vector: serving
    passes one position per slot, lockstep callers a scalar."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=device)
    if pos.dim() == 0:
        return pos.expand(b)
    return pos


def gqa_forward(p: Params, x: torch.Tensor, a: AttnConfig, *,
                positions: torch.Tensor, causal: bool = True,
                prefix_len: int = 0,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos=None, active: Optional[torch.Tensor] = None):
    """Standard GQA attention.

    Without cache: self-attention over x (prefill); returns (out, (k, v))
    so prefill can seed a cache.  With cache (k, v of shape (B,Hkv,S,dh))
    and ``cache_pos`` (scalar, or a (B,) per-slot position vector):
    single-step decode — x is (B,1,D); each lane's new k/v is written at
    its own position in place (lanes where ``active`` is False write
    nothing) and attention runs over the per-lane-masked cache."""
    b, s, _ = x.shape
    h, kv, dh = a.n_heads, a.n_kv_heads, a.head_dim
    q = _split_heads(dense(x, p["wq"]), h, dh)
    k = _split_heads(dense(x, p["wk"]), kv, dh)
    v = _split_heads(dense(x, p["wv"]), kv, dh)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    # (B,S,H,dh) -> (B,H,S,dh): the kernels take contiguous operands only
    q = q.transpose(1, 2).contiguous()
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()

    if cache is None:
        out = halo_dispatch("FLASH_ATTN", q, k, v, causal=causal,
                            window=a.window, prefix_len=prefix_len)
        new_kv = (k, v)
    else:
        if s != 1:
            raise NotImplementedError(_CHUNK)
        ck, cv = cache
        lc = ck.shape[2]
        # ring buffer when the cache is window-sized (transformer.ring_len)
        ring = a.window is not None and lc <= a.window and not prefix_len
        pos = _lane_positions(cache_pos, b, x.device)
        slot = torch.remainder(pos, lc) if ring else pos
        lane = torch.arange(b, device=x.device)
        kn, vn = k[:, :, 0].to(ck.dtype), v[:, :, 0].to(cv.dtype)
        if active is not None:
            # inactive lanes write back what they hold (no host sync)
            keep = torch.as_tensor(active, dtype=torch.bool,
                                   device=x.device)[:, None, None]
            kn = torch.where(keep, kn, ck[lane, :, slot])
            vn = torch.where(keep, vn, cv[lane, :, slot])
        ck[lane, :, slot] = kn
        cv[lane, :, slot] = vn
        out = decode_attention(q, ck, cv, pos, a, prefix_len=prefix_len,
                               ring=ring)
        new_kv = (ck, cv)

    out = shard(out.transpose(1, 2).reshape(b, s, h * dh), "batch", None, "tp")
    out = dense(out, p["wo"])
    return shard(out, "batch", None, None), new_kv


def decode_attention(q, ck, cv, pos, a: AttnConfig, *, prefix_len: int = 0,
                     ring: bool = False):
    """Single-query attention over a (B,Hkv,S,dh) cache, masked per lane.

    ``pos`` is scalar or a (B,) vector — each lane masks against its own
    position, which lets slots at different depths share one step.  With
    ``ring=True`` the cache is a window-sized ring buffer: every occupied
    slot is in-window by construction, so masking reduces to occupancy
    (slot index ≤ pos, all-true once the ring wraps)."""
    bq, h, sq, dh = q.shape
    kvh = ck.shape[1]
    rep = h // kvh
    pos = _lane_positions(pos, bq, q.device)
    qf = q.float().reshape(bq, kvh, rep * sq, dh) * (dh ** -0.5)
    s = torch.einsum("bgqd,bgkd->bgqk", qf, ck.float())
    kpos = torch.arange(ck.shape[2], device=q.device)
    mask = kpos[None, :] <= pos[:, None]        # per-lane causal mask (B,S)
    if a.window is not None and not ring:
        wm = kpos[None, :] > pos[:, None] - a.window
        if prefix_len:
            wm = wm | (kpos[None, :] < prefix_len)
        mask = mask & wm
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p_att = torch.softmax(s, dim=-1)
    out = torch.einsum("bgqk,bgkd->bgqd", p_att, cv.float())
    return out.reshape(bq, h, sq, dh).to(q.dtype)


def mla_forward(p: Params, x: torch.Tensor, a: AttnConfig, **kwargs):
    """Multi-head latent attention (DeepSeek-V2): not ported yet."""
    raise NotImplementedError(_MLA)
