"""Plain PyTorch oracle for FLASH_ATTN (port of
``repro.kernels.flash_attention.ref``) and the library row."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def visibility(sq: int, skv: int, *, causal: bool, window, prefix_len: int,
               device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees.  Positions are aligned at
    the end: query i sits at Skv − Sq + i (the decode convention)."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        cmask = qpos >= kpos
        if prefix_len:
            cmask = cmask | (kpos < prefix_len)
        mask = mask & cmask
    if window is not None:
        wmask = kpos > qpos - window
        if prefix_len:
            wmask = wmask | (kpos < prefix_len)
        mask = mask & wmask
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  prefix_len: int = 0, scale=None):
    """Reference attention, q (B,H,Sq,D), k/v (B,Hkv,Skv,D); GQA by head
    repetition (KV head h // (H/Hkv)); masked scores are −1e30, so a query
    that sees no key gets the mean of v.  Float32 inside, q's type out."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = visibility(sq, skv, causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_mma_ref(q, k, v, *, causal: bool = True, window=None,
                      prefix_len: int = 0, tile: int = 64):
    """The tensor-core route's plain model, in its steps: float32 scores
    q·kᵀ·D^-1/2 with the masks of :func:`visibility` (masked −1e30), then
    per ``tile`` keys in order an online softmax: m the running row max
    (from −1e30), p = exp(s − m) rounded to q's type, l and o rescaled by
    exp(m_old − m_new) and summed from that rounded p in float32, o += p·v;
    o / l in q's type.  A query that sees no key gets the mean of v."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    mask = visibility(sq, skv, causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    s = s.masked_fill(~mask, -1e30)
    vf = v.float()
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, skv, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new).to(q.dtype).float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + tile])
        m = m_new
    return (o / l).to(q.dtype)


def attention_aten(q, k, v, *, causal: bool = True, window=None,
                   prefix_len: int = 0):
    """The library row: one ``F.scaled_dot_product_attention``.  SDPA's
    ``is_causal`` aligns the diagonal top-left, the reference at the end, so
    an explicit boolean mask goes in whenever Sq ≠ Skv, a window is set or
    a prefix is bidirectional.  A query that sees no key gives NaN here."""
    sq, skv = q.shape[2], k.shape[2]
    gqa = q.shape[1] != k.shape[1]
    if window is None and (not causal or (sq == skv and not prefix_len)):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=gqa)
    mask = visibility(sq, skv, causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=gqa)
