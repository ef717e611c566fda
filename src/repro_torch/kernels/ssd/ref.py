"""Plain PyTorch oracle for SSD (Mamba-2 state-space duality,
arXiv:2405.21060) — port of ``repro.kernels.ssd.ref``.

Sequential scan over the discretized selective-SSM recurrence:

    h_t = exp(dA_t) * h_{t-1} + dt_t * x_t ⊗ B_t
    y_t = C_t · h_t + D * x_t

Shapes: x (B,S,H,P), dt (B,S,H), a (H,) negative decay, b/c (B,S,G,N) with
G group-shared states (G divides H), d (H,).
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a, b, c, d, *, chunk: int = 0, return_state: bool = False):
    """The scan, one step a position, in float32; y in x's type, and with
    ``return_state`` also the final (B,H,P,N) float32 state.  ``chunk`` is
    accepted for the chunked form's signature and ignored."""
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    bf = b.float().repeat_interleave(rep, dim=2)          # (B,S,H,N)
    cf = c.float().repeat_interleave(rep, dim=2)
    xf = x.float()
    dtf = dt.float()
    da = torch.exp(dtf * a.float())                       # (B,S,H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(seq):
        state = state * da[:, t, :, None, None] \
            + (dtf[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, :, None, :]
        ys.append((state * cf[:, t, :, None, :]).sum(-1))   # (B,H,P)
    y = torch.stack(ys, dim=1) + xf * d.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, state
    return y
