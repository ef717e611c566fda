"""Plain PyTorch oracle for FLASH_ATTN (port of
``repro.kernels.flash_attention.ref``) and the library row."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..matmul.ref import tf32_split
from .flash_attention import tf32x3_key_tile


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


def _repeat_kv(k, v, h):
    """k and v with each KV head repeated for its H / Hkv query heads."""
    if h != k.shape[1]:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    return k, v


def _attention(q, k, v, wide, *, causal, window, prefix_len, scale):
    """Softmax attention in type ``wide`` (masked scores −1e30)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, h)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wide), k.to(wide)) * scale
    mask = visibility(sq, skv, causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(wide))


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  prefix_len: int = 0, scale=None):
    """Reference attention, q (B,H,Sq,D), k/v (B,Hkv,Skv,D); GQA by head
    repetition (KV head h // (H/Hkv)); masked scores are −1e30, so a query
    that sees no key gets the mean of v.  Float32 inside, q's type out."""
    return _attention(q, k, v, torch.float32, causal=causal, window=window,
                      prefix_len=prefix_len, scale=scale).to(q.dtype)


def attention_f64(q, k, v, *, causal: bool = True, window=None,
                  prefix_len: int = 0):
    """:func:`attention_ref` in float64 throughout, returned in float64: the
    yardstick of the float32 routes' own error."""
    return _attention(q, k, v, torch.float64, causal=causal, window=window,
                      prefix_len=prefix_len, scale=None)


def attention_mma_ref(q, k, v, *, causal: bool = True, window=None,
                      prefix_len: int = 0, tile: int = 64):
    """The tensor-core route's plain model, in its steps: float32 scores
    q·kᵀ·D^-1/2 with the masks of :func:`visibility` (masked −1e30), then
    per ``tile`` keys in order an online softmax: m the running row max
    (from −1e30), p = exp(s − m) rounded to q's type, l and o rescaled by
    exp(m_old − m_new) and summed from that rounded p in float32, o += p·v;
    o / l in q's type.  A query that sees no key gets the mean of v."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, h)
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


#: the three products of a 3×TF32 step, (a part, b part): A_lo·B_hi,
#: A_hi·B_lo, A_hi·B_hi (A_lo·B_lo is left out, as the kernels leave it out)
TF32X3_TERMS = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
#: head-dim columns of one q·kᵀ block, and keys of one p·v sum, that the
#: 3×TF32 kernel adds in a fresh accumulator
TF32X3_BLOCK = 32


def attention_tf32x3_ref(q, k, v, *, causal: bool = True, window=None,
                         prefix_len: int = 0, tile=None, qk_terms=TF32X3_TERMS,
                         pv_terms=TF32X3_TERMS):
    """The 3×TF32 route's plain model, in its steps, all in float32.

    Every operand is split into TF32 hi + lo (:func:`tf32_split`).  Scores:
    per :data:`TF32X3_BLOCK` columns of the head dim, q_lo·k_hiᵀ +
    q_hi·k_loᵀ + q_hi·k_hiᵀ, the blocks added in order, times D^-1/2, with
    the masks of :func:`visibility` (masked −1e30).  Then per ``tile`` keys
    in order (the kernel's, :func:`~.flash_attention.tf32x3_key_tile`, by
    default) an online softmax: m the running row max (from −1e30), p =
    exp(s − m) split into hi + lo, l and o rescaled by exp(m_old − m_new), l
    += Σ(hi + lo), and o += p_lo·v_hi + p_hi·v_lo + p_hi·v_hi per
    :data:`TF32X3_BLOCK` keys, each such sum added to o; o / l.
    ``qk_terms`` and ``pv_terms`` name the products each sum takes
    (:data:`TF32X3_TERMS`; fewer model a kernel that drops one).  A query
    that sees no key gets the mean of v."""
    stage = chunk = TF32X3_BLOCK
    b, h, sq, d = q.shape
    skv = k.shape[2]
    tile = tf32x3_key_tile(d) if tile is None else tile
    k, v = _repeat_kv(k, v, h)
    qs, ks, vs = (dict(zip(("hi", "lo"), tf32_split(t.float()))) for t in (q, k, v))

    def product(spec, terms, a, b_, a_cut, b_cut):
        return sum(torch.einsum(spec, a[x][a_cut], b_[y][b_cut]) for x, y in terms)

    s = None
    for d0 in range(0, d, stage):
        c = (..., slice(d0, d0 + stage))
        part = product("bhqd,bhkd->bhqk", qk_terms, qs, ks, c, c)
        s = part if s is None else s + part
    s = s * d ** -0.5
    mask = visibility(sq, skv, causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    s = s.masked_fill(~mask, -1e30)
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, skv, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        ps = dict(zip(("hi", "lo"), tf32_split(torch.exp(st - m_new))))
        corr = torch.exp(m - m_new)
        l = l * corr + (ps["hi"] + ps["lo"]).sum(dim=-1, keepdim=True)
        o = o * corr
        width = st.shape[-1]
        for c0 in range(0, width, chunk):
            c1 = min(c0 + chunk, width)
            o = o + product("bhqk,bhkd->bhqd", pv_terms, ps, vs, (..., slice(c0, c1)),
                            (slice(None), slice(None), slice(k0 + c0, k0 + c1)))
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
