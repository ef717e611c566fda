"""SSD chunked (quadratic within a chunk, linear across chunks) and the O(1)
decode step — port of ``repro.kernels.ssd.ops``.

The Mamba-2 "state-space duality" form (arXiv:2405.21060, §6): split the
sequence into chunks of Q; within a chunk the recurrence is a masked,
attention-like product against the decay matrix L, across chunks a short
loop carries the (H,P,N) states.  Every product is an explicit float32
batched ``torch.matmul`` in a fixed order (C·Bᵀ per group, then ·L, then
·(dt·x)), so no path planner builds a (B,c,Q,Q,H,N) intermediate.

These are the ``aten`` rows of SSD and SSD_DECODE.  There is no ``hopper``
row: the reference registers no Pallas SSD, and the port adds no kernel
the JAX package lacks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(…, T) → (…, T, T) lower-triangular pairwise cumulative sums, −inf
    above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a, b, c, d, *, chunk: int = 128,
                return_state: bool = False):
    """Chunked SSD.  Shapes as in :func:`..ssd.ref.ssd_ref`.

    With ``return_state=True`` also returns the final (B,H,P,N) float32
    state (prefill seeds the decode cache with it)."""
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    q = min(chunk, seq)
    pad = (-seq) % q
    if pad:
        # dt = 0 ⇒ exp(dt·a) = 1 and dt·x = 0: padded steps are identity
        # updates, so the final state and the real positions are unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    s_pad = seq + pad
    nc = s_pad // q

    # heads as (G, rep): head i reads group i // rep, as jnp.repeat lays out
    xf = x.float().reshape(bsz, nc, q, g, rep, p).permute(0, 3, 4, 1, 2, 5)
    dtf = dt.float().reshape(bsz, nc, q, g, rep).permute(0, 3, 4, 1, 2)
    bg = b.float().reshape(bsz, nc, q, g, n).permute(0, 3, 1, 2, 4)[:, :, None]
    cg = c.float().reshape(bsz, nc, q, g, n).permute(0, 3, 1, 2, 4)[:, :, None]
    # xf (B,G,R,c,Q,P), dtf (B,G,R,c,Q), bg/cg (B,G,1,c,Q,N)
    da = dtf * a.float().reshape(g, rep)[None, :, :, None, None]
    da_cs = torch.cumsum(da, dim=-1)                      # (B,G,R,c,Q)
    xdt = xf * dtf[..., None]                             # dt-weighted inputs

    # 1. intra-chunk (diagonal blocks): (C·Bᵀ ∘ L) · (dt·x)
    decay = torch.exp(_segsum(da))                        # (B,G,R,c,Q,Q)
    scores = torch.matmul(cg, bg.transpose(-1, -2))       # (B,G,1,c,Q,Q)
    y_diag = torch.matmul(scores * decay, xdt)            # (B,G,R,c,Q,P)

    # 2. each chunk's final state: (dt·x ∘ decay to the chunk's end)ᵀ · B
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)     # (B,G,R,c,Q)
    states = torch.matmul((xdt * decay_states[..., None]).transpose(-1, -2),
                          bg)                             # (B,G,R,c,P,N)

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_cs[..., -1])               # (B,G,R,c)
    state = torch.zeros_like(states[:, :, :, 0])
    entering = []
    for i in range(nc):
        entering.append(state)
        state = state * chunk_decay[..., i, None, None] + states[:, :, :, i]
    h_in = torch.stack(entering, dim=3)                   # (B,G,R,c,P,N)

    # 4. the entering state's contribution to each position
    y_off = torch.matmul(cg, h_in.transpose(-1, -2)) \
        * torch.exp(da_cs)[..., None]                     # (B,G,R,c,Q,P)

    y = (y_diag + y_off).permute(0, 3, 4, 1, 2, 5).reshape(bsz, s_pad, h, p) \
        + x.float() * d.float()[None, None, :, None]
    y = y.to(x.dtype)[:, :seq]
    if return_state:
        return y, state.reshape(bsz, h, p, n)
    return y


def ssd_decode_step(h, x_t, dt_t, a, b_t, c_t, d):
    """O(1) recurrent decode step.

    h (B,H,P,N) float32 state; x_t (B,H,P); dt_t (B,H); b_t/c_t (B,G,N);
    d (H,).  Returns (h_new, y_t), y_t in x_t's type; ``h`` is not written."""
    rep = h.shape[1] // b_t.shape[1]
    bf = b_t.float().repeat_interleave(rep, dim=1)        # (B,H,N)
    cf = c_t.float().repeat_interleave(rep, dim=1)
    xf = x_t.float()
    dtf = dt_t.float()
    da = torch.exp(dtf * a.float())                       # (B,H)
    h = h * da[..., None, None] + (dtf[..., None] * xf)[..., None] \
        * bf[:, :, None, :]
    y = torch.matmul(h, cf[..., None])[..., 0] + xf * d.float()[None, :, None]
    return h, y.to(x_t.dtype)
