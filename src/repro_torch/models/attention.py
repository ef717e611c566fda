"""Attention blocks: GQA/MQA (+SWA, prefix-LM) and MLA — port of
``repro.models.attention``.

Sequence-level attention (prefill) routes through the FLASH_ATTN alias;
attention through the cache — one decode token, or one chunk of a chunked
prefill (``chunk_attention``, ``chunk_ring_attention``, MLA's multi-token
step) — is inline masked float32 einsum, as in the reference, where it is
no Pallas kernel either.  The cache paths write each lane's new keys and
values (MLA: latent and rope key) into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import AttnConfig
from ..core.c2mpi import halo_dispatch
from ..distributed.sharding import ParamSpec, shard
from .layers import dense, rms_norm, rope

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameter planning
# ---------------------------------------------------------------------------
def attn_param_specs(d_model: int, a: AttnConfig, dtype) -> Dict[str, ParamSpec]:
    h, kv, dh = a.n_heads, a.n_kv_heads, a.head_dim
    if a.kv_lora:                                   # MLA (DeepSeek-V2)
        qk_nope = dh
        return {
            "wdq": ParamSpec((d_model, a.q_lora), dtype, ("fsdp", None)),
            "q_ln": ParamSpec((a.q_lora,), dtype, (None,), init_kind="ones"),
            "wuq": ParamSpec((a.q_lora, h * (qk_nope + a.rope_head_dim)),
                             dtype, ("fsdp", "tp")),
            "wdkv": ParamSpec((d_model, a.kv_lora), dtype, ("fsdp", None)),
            "kv_ln": ParamSpec((a.kv_lora,), dtype, (None,), init_kind="ones"),
            "wkrope": ParamSpec((d_model, a.rope_head_dim), dtype,
                                ("fsdp", None)),
            "wuk": ParamSpec((a.kv_lora, h * qk_nope), dtype, ("fsdp", "tp")),
            "wuv": ParamSpec((a.kv_lora, h * a.v_head_dim), dtype,
                             ("fsdp", "tp")),
            "wo": ParamSpec((h * a.v_head_dim, d_model), dtype,
                            ("tp", "fsdp")),
        }
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
    and ``cache_pos`` (scalar, or a (B,) per-slot position vector): x is
    (B,1,D) for one decode step — each lane's new k/v is written at its own
    position in place (lanes where ``active`` is False write nothing) and
    attention runs over the per-lane-masked cache — or (B,C,D) for one
    prefill chunk at positions ``cache_pos + arange(C)``."""
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
        ck, cv = cache
        lc = ck.shape[2]
        # ring buffer when the cache is window-sized (transformer.ring_len)
        ring = a.window is not None and lc <= a.window and not prefix_len
        pos = _lane_positions(cache_pos, b, x.device)
        lane = torch.arange(b, device=x.device)
        if s == 1:
            slot = torch.remainder(pos, lc) if ring else pos
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
        else:
            slot = pos[:, None] + torch.arange(s, device=x.device)   # (B,C)
            if ring:
                # a chunk over a ring cache attends over (old ring ‖ chunk)
                # *before* writing: an in-place chunk write can overwrite
                # in-window keys that earlier chunk queries still need; the
                # engine clamps chunks to <= lc, so the write never
                # collides with itself
                out = chunk_ring_attention(q, ck, cv, k, v, pos, a)
                slot = torch.remainder(slot, lc)
            # (B,C) lanes × slots with heads between: the write is (B,C,H,dh)
            ck[lane[:, None], :, slot] = k.transpose(1, 2).to(ck.dtype)
            cv[lane[:, None], :, slot] = v.transpose(1, 2).to(cv.dtype)
            if not ring:
                # full-length cache: written first, then per-query causal
                # masks — query p0+i hides keys past itself, which covers
                # both the chunk's own future and any stale tail
                out = chunk_attention(q, ck, cv, pos, a,
                                      prefix_len=prefix_len)
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


def chunk_attention(q, ck, cv, p0, a: AttnConfig, *, prefix_len: int = 0):
    """Multi-query attention for one prefill chunk over a full-length
    (B,Hkv,S,dh) cache, the chunk already written at positions
    p0..p0+C-1.

    The per-query causal mask ``kpos <= p0+i`` plays the decode mask's
    role: whatever a previous occupant (or the chunk's own future) left
    beyond each query's position scores exactly -1e30, so chunked and
    whole-prompt prefill agree to the sum order."""
    bq, h, c, dh = q.shape
    kvh = ck.shape[1]
    rep = h // kvh
    p0 = _lane_positions(p0, bq, q.device)
    qf = (q.float() * dh ** -0.5).reshape(bq, kvh, rep, c, dh)
    s = torch.einsum("bgrcd,bgkd->bgrck", qf, ck.float())
    kpos = torch.arange(ck.shape[2], device=q.device)
    gi = p0[:, None] + torch.arange(c, device=q.device)       # (B,C) query pos
    mask = kpos[None, None, :] <= gi[:, :, None]              # (B,C,K)
    if a.window is not None:
        wm = kpos[None, None, :] > gi[:, :, None] - a.window
        if prefix_len:
            wm = wm | (kpos[None, None, :] < prefix_len)
        mask = mask & wm
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p_att = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrck,bgkd->bgrcd", p_att, cv.float())
    return out.reshape(bq, h, c, dh).to(q.dtype)


def chunk_ring_attention(q, ck, cv, kn, vn, p0, a: AttnConfig):
    """Multi-query chunk attention over a window-sized (B,Hkv,lc,dh) ring
    cache.

    The chunk is *not* written yet: ring slot ``p % lc`` of a late chunk
    position would overwrite a key an earlier chunk query still needs, so
    scores run over the concatenation (old ring ‖ chunk keys ``kn``/``vn``,
    (B,Hkv,C,dh)) with explicit occupancy masks, and the caller writes the
    chunk afterwards.

    Old ring slot ``j`` holds position ``p_j = (p0-1) - ((p0-1-j) mod lc)``
    — the latest pre-chunk position congruent to ``j`` — valid for query
    ``g_i = p0+i`` iff it exists (``j < p0`` or the ring already wrapped)
    and is still in-window (``p_j > g_i - window``).  Chunk key ``t``
    (position ``p0+t``) is valid iff ``t <= i``; it is always in-window
    because the chunk length is clamped to ``lc <= window``."""
    bq, h, c, dh = q.shape
    kvh = ck.shape[1]
    rep = h // kvh
    lc = ck.shape[2]
    dev = q.device
    p0 = _lane_positions(p0, bq, dev)
    gi = p0[:, None] + torch.arange(c, device=dev)            # (B,C)
    j = torch.arange(lc, device=dev)
    pj = (p0[:, None] - 1) - torch.remainder(p0[:, None] - 1 - j[None, :], lc)
    exists = (j[None, :] < p0[:, None]) | (p0[:, None] >= lc)
    old_ok = exists[:, None, :] & (pj[:, None, :] > gi[:, :, None] - a.window)
    t = torch.arange(c, device=dev)
    new_ok = (t[None, None, :] <= t[None, :, None]).expand(bq, c, c)
    mask = torch.cat([old_ok, new_ok], dim=-1)                # (B,C,lc+C)
    kf = torch.cat([ck.float(), kn.float()], dim=2)
    vf = torch.cat([cv.float(), vn.float()], dim=2)
    qf = (q.float() * dh ** -0.5).reshape(bq, kvh, rep, c, dh)
    s = torch.einsum("bgrcd,bgkd->bgrck", qf, kf)
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p_att = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrck,bgkd->bgrcd", p_att, vf)
    return out.reshape(bq, h, c, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA forward (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------
def mla_forward(p: Params, x: torch.Tensor, a: AttnConfig, *,
                positions: torch.Tensor, norm_eps: float = 1e-6,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos=None, active: Optional[torch.Tensor] = None):
    """Multi-head latent attention.

    Prefill: decompress K and V per head and run FLASH_ATTN over the
    concatenated (nope ‖ rope) queries and keys, the rope key broadcast
    over heads; V is zero-padded to the q·k width (128 → 192) and cut back
    after, and the scale is (nope + rope)^-1/2.  Returns the latent cache
    (ckv (B,S,kv_lora), k_rope (B,S,rope)).  Decode: the *absorbed* form in
    float32 einsums — queries are projected into the latent space and
    attend over the cached latent plus the shared rope key, so the cache
    holds (B,S,kv_lora) + (B,S,rope) instead of per-head K and V.  Each
    lane writes its latent and rope key at its position in place; lanes
    where ``active`` is False write back what they hold."""
    b, s, _ = x.shape
    h, dh = a.n_heads, a.head_dim                    # dh = qk_nope dim
    rdh, vdh, lat = a.rope_head_dim, a.v_head_dim, a.kv_lora

    cq = rms_norm(dense(x, p["wdq"]), p["q_ln"], norm_eps)
    q = dense(cq, p["wuq"]).reshape(b, s, h, dh + rdh)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = rope(q_rope, positions, a.rope_theta)

    ckv = rms_norm(dense(x, p["wdkv"]), p["kv_ln"], norm_eps)   # (B,S,lat)
    k_rope = rope(dense(x, p["wkrope"])[:, :, None, :], positions,
                  a.rope_theta)[:, :, 0]                        # (B,S,rdh)

    if cache is None:
        k_nope = dense(ckv, p["wuk"]).reshape(b, s, h, dh)
        val = dense(ckv, p["wuv"]).reshape(b, s, h, vdh)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rdh)],
                           dim=-1)
        # (B,S,H,·) -> (B,H,S,·): the kernels take contiguous operands only
        qh = q_full.transpose(1, 2).contiguous()
        kh = k_full.transpose(1, 2).contiguous()
        vh = F.pad(val, (0, dh + rdh - vdh)).transpose(1, 2).contiguous()
        out = halo_dispatch("FLASH_ATTN", qh, kh, vh, causal=True)
        out = shard(out[..., :vdh].transpose(1, 2).reshape(b, s, h * vdh),
                    "batch", None, "tp")
        new_cache = (ckv, k_rope)
    else:
        cl, cr = cache                               # (B,S,lat), (B,S,rdh)
        pos = _lane_positions(cache_pos, b, x.device)
        lane = torch.arange(b, device=x.device)
        if s == 1:
            cn, rn = ckv[:, 0].to(cl.dtype), k_rope[:, 0].to(cr.dtype)
            if active is not None:
                # inactive lanes write back what they hold (no host sync)
                keep = torch.as_tensor(active, dtype=torch.bool,
                                       device=x.device)[:, None]
                cn = torch.where(keep, cn, cl[lane, pos])
                rn = torch.where(keep, rn, cr[lane, pos])
            cl[lane, pos] = cn
            cr[lane, pos] = rn
            qpos = pos[:, None]                      # (B,1) query positions
        else:
            # chunked prefill: write first; the per-query causal mask below
            # hides the chunk's own future exactly like stale tail garbage
            qpos = pos[:, None] + torch.arange(s, device=x.device)   # (B,C)
            cl[lane[:, None], qpos] = ckv.to(cl.dtype)
            cr[lane[:, None], qpos] = k_rope.to(cr.dtype)
        wuk = p["wuk"].reshape(lat, h, dh)
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope.float(), wuk.float())
        s_lat = torch.einsum("bshl,btl->bhst", q_lat, cl.float())
        s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), cr.float())
        scores = (s_lat + s_rope) * (dh + rdh) ** -0.5
        kpos = torch.arange(cl.shape[1], device=x.device)
        visible = kpos[None, None, :] <= qpos[:, :, None]   # per query (B,S,T)
        scores = scores.masked_fill(~visible[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhst,btl->bshl", probs, cl.float())
        wuv = p["wuv"].reshape(lat, h, vdh)
        out = torch.einsum("bshl,lhv->bshv", ctx_lat, wuv.float())
        out = out.reshape(b, s, h * vdh).to(x.dtype)
        new_cache = (cl, cr)

    out = dense(out, p["wo"])
    return shard(out, "batch", None, None), new_cache
