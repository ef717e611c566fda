"""Block-tiled online-softmax attention in plain, differentiable torch —
port of ``repro.kernels.flash_attention.xla``.

The same FlashAttention recurrence as the kernels, written as a double
block loop (q-chunks × kv-chunks) in Python, so that no (Sq, Skv) score
matrix is ever materialized (memory O(bq·bk)) and a tile that the causal,
window and prefix masks hide whole is skipped before any work is done.
FLASH_ATTN's backward is this function's VJP, as in the reference: it
recomputes the forward under autograd, block by block.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _block(qf, kb, q0, k0, bq_len, bk_len, *, causal, window, prefix_len, skv,
           q_offset):
    """One (q-chunk, kv-chunk) tile's masked scores (B,G,R,bq,bk)."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kb.float())
    qpos = q0 + torch.arange(bq_len, device=qf.device) + q_offset
    kpos = k0 + torch.arange(bk_len, device=qf.device)
    mask = (kpos[None, :] < skv).expand(bq_len, bk_len)
    if causal:
        cm = qpos[:, None] >= kpos[None, :]
        if prefix_len:
            cm = cm | (kpos[None, :] < prefix_len)
        mask = mask & cm
    if window is not None:
        wm = kpos[None, :] > qpos[:, None] - window
        if prefix_len:
            wm = wm | (kpos[None, :] < prefix_len)
        mask = mask & wm
    return s.masked_fill(~mask, _NEG_INF)


def _skip(q0, q1, k0, k1, *, causal, window, prefix_len, q_offset) -> bool:
    """True when the whole (q-chunk, kv-chunk) tile is masked."""
    qmin, qmax = q0 + q_offset, q1 - 1 + q_offset
    kmin, kmax = k0, k1 - 1
    if causal and kmin > qmax:
        return True                      # entirely in the future
    if window is not None and kmax < qmin - window + 1:
        if prefix_len and kmin < prefix_len:
            return False                 # prefix columns stay visible
        return True                      # entirely past the window
    return False


def mea_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, bq: int = 4096, bk: int = 2048):
    """q (B,H,Sq,D), k/v (B,Hkv,Skv,D) → (B,H,Sq,D) in q's type; query i at
    position Skv − Sq + i, scale D^-1/2, float32 inside; masked scores are
    −1e30, as in the reference."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    rep = h // hkv
    bq = min(bq, sq)
    bk = min(bk, skv)
    qpad = (-sq) % bq
    kpad = (-skv) % bk
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, qpad))
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, kpad))
    nq = (sq + qpad) // bq
    nk = (skv + kpad) // bk
    scale = d ** -0.5
    q_offset = skv - sq
    qs = q.reshape(b, hkv, rep, nq * bq, d)

    outs = []
    for qi in range(nq):
        q0 = qi * bq
        qf = qs[:, :, :, q0:q0 + bq].float() * scale
        m = torch.full((b, hkv, rep, bq), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, rep, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, rep, bq, d), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            k0 = ki * bk
            if _skip(q0, q0 + bq, k0, k0 + bk, causal=causal, window=window,
                     prefix_len=prefix_len, q_offset=q_offset):
                continue
            kb = k[:, :, k0:k0 + bk]
            vb = v[:, :, k0:k0 + bk]
            s = _block(qf, kb, q0, k0, bq, bk, causal=causal, window=window,
                       prefix_len=prefix_len, skv=skv, q_offset=q_offset)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p, vb.float())
            m = m_new
        safe = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(acc / safe[..., None])
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out[:, :, :, :sq].reshape(b, h, sq, d).to(q.dtype)
