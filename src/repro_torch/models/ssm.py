"""Mamba-2 block (SSD, arXiv:2405.21060), sequence and recurrent decode
paths — port of ``repro.models.ssm``.

The in-projection is split into z/x/BC/dt projections, as in the
reference (its TP adaptation), each through the MMM alias; the depthwise
causal conv is inline, channel-local PyTorch (the reference's is no Pallas
kernel either); the scan dispatches SSD (prefill) or SSD_DECODE (one
token).  The decode path writes each lane's new conv and SSM states into
the slot cache in place; lanes where ``active`` is False keep theirs bit
for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..core.c2mpi import halo_dispatch
from ..distributed.sharding import ParamSpec, shard
from .layers import dense, rms_norm

Params = Dict[str, torch.Tensor]


def ssm_dims(d_model: int, s: SSMConfig):
    d_in = s.expand * d_model
    n_heads = d_in // s.head_dim
    d_bc = 2 * s.n_groups * s.state_dim
    return d_in, n_heads, d_bc


def mamba_param_specs(d_model: int, s: SSMConfig, dtype) -> Dict[str, ParamSpec]:
    """The block's weights in ``dtype``; ``a_log``, ``dt_bias`` and
    ``d_skip`` are float32 whatever ``dtype`` is."""
    d_in, h, d_bc = ssm_dims(d_model, s)
    w = s.conv_width
    return {
        "wz": ParamSpec((d_model, d_in), dtype, ("fsdp", "tp")),
        "wx": ParamSpec((d_model, d_in), dtype, ("fsdp", "tp")),
        "wbc": ParamSpec((d_model, d_bc), dtype, ("fsdp", None)),
        "wdt": ParamSpec((d_model, h), dtype, ("fsdp", None)),
        "conv_x_w": ParamSpec((d_in, w), dtype, ("tp", None)),
        "conv_x_b": ParamSpec((d_in,), dtype, ("tp",), init_kind="zeros"),
        "conv_bc_w": ParamSpec((d_bc, w), dtype, (None, None)),
        "conv_bc_b": ParamSpec((d_bc,), dtype, (None,), init_kind="zeros"),
        "a_log": ParamSpec((h,), torch.float32, (None,), init_kind="a_log"),
        "dt_bias": ParamSpec((h,), torch.float32, (None,), init_kind="dt_bias"),
        "d_skip": ParamSpec((h,), torch.float32, (None,), init_kind="ones"),
        "norm": ParamSpec((d_in,), dtype, ("tp",), init_kind="ones"),
        "out_proj": ParamSpec((d_in, d_model), dtype, ("tp", "fsdp")),
    }


def _causal_conv_seq(u: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by ``width`` shifts.  u (B,S,C), w (C,W).
    A shift past S contributes zeros (the reference's ``u[:, :-shift]``
    padded by ``shift`` has the wrong length there, so it fails on
    S < W−1)."""
    width, seq = w.shape[1], u.shape[1]
    acc = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(width):
        shift = width - 1 - i
        seg = F.pad(u, (0, 0, shift, 0))[:, :seq] if shift else u
        acc += seg.float() * w[:, i].float()
    return (acc + b.float()).to(u.dtype)


def _causal_conv_step(state: torch.Tensor, u_t: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """state (B,C,W-1) holds the previous inputs; u_t (B,C).  Returns the
    next state and the output; ``state`` is not written."""
    full = torch.cat([state, u_t[:, :, None]], dim=2)          # (B,C,W)
    y = (full.float() * w.float()[None]).sum(dim=2) + b.float()
    return full[:, :, 1:], y.to(u_t.dtype)


def _silu(t: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(t.float()).to(dtype)


def mamba_forward(p: Params, x: torch.Tensor, s: SSMConfig, *,
                  cache: Optional[Tuple] = None,
                  active: Optional[torch.Tensor] = None):
    """x (B,S,D).  Without ``cache``: the sequence path (prefill), which
    also returns a decode-ready cache: the conv states are the last W−1
    pre-activation inputs, left-padded with zeros when S < W−1, and the
    SSM state is the scan's final one (the reference's ``want_cache``;
    training discards it).  With ``cache`` =
    (conv_x_state, conv_bc_state, ssm_state): one decode token (S = 1),
    the states advanced in place but in lanes where ``active`` is False."""
    b, seq, d_model = x.shape
    d_in, h, d_bc = ssm_dims(d_model, s)
    g, n, pdim = s.n_groups, s.state_dim, s.head_dim

    z = shard(dense(x, p["wz"]), "batch", None, "tp")
    xr_pre = shard(dense(x, p["wx"]), "batch", None, "tp")
    bc = dense(x, p["wbc"])
    dt_raw = dense(x, p["wdt"])
    a = -torch.exp(p["a_log"].float())

    if cache is None:
        xr = _silu(_causal_conv_seq(xr_pre, p["conv_x_w"], p["conv_x_b"]), x.dtype)
        bcv = _silu(_causal_conv_seq(bc, p["conv_bc_w"], p["conv_bc_b"]), x.dtype)
        bmat = bcv[..., :g * n].reshape(b, seq, g, n)
        cmat = bcv[..., g * n:].reshape(b, seq, g, n)
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        xh = shard(xr.reshape(b, seq, h, pdim), "batch", None, "tp", None)
        dt = shard(dt, "batch", None, "tp")
        y, h_final = halo_dispatch("SSD", xh, dt, a, bmat, cmat, p["d_skip"],
                                   chunk=min(s.chunk, seq), return_state=True)
        keep = s.conv_width - 1
        # conv states = the last W-1 pre-activation projected inputs
        conv_x_state = xr_pre[:, -keep:].transpose(1, 2)
        conv_bc_state = bc[:, -keep:].transpose(1, 2)
        if seq < keep:
            conv_x_state = F.pad(conv_x_state, (keep - seq, 0))
            conv_bc_state = F.pad(conv_bc_state, (keep - seq, 0))
        new_cache = (conv_x_state, conv_bc_state, h_final)
        y = y.reshape(b, seq, d_in)
    else:
        conv_x_state, conv_bc_state, hstate = cache
        next_x, xt = _causal_conv_step(conv_x_state, xr_pre[:, 0],
                                       p["conv_x_w"], p["conv_x_b"])
        next_bc, bct = _causal_conv_step(conv_bc_state, bc[:, 0],
                                         p["conv_bc_w"], p["conv_bc_b"])
        xt = _silu(xt, x.dtype)
        bct = _silu(bct, x.dtype)
        bmat = bct[..., :g * n].reshape(b, g, n)
        cmat = bct[..., g * n:].reshape(b, g, n)
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
        next_h, y = halo_dispatch("SSD_DECODE", hstate, xt.reshape(b, h, pdim),
                                  dt, a, bmat, cmat, p["d_skip"])
        y = y.reshape(b, 1, d_in)
        lanes = None if active is None else torch.as_tensor(
            active, dtype=torch.bool, device=x.device)
        for old, new in ((conv_x_state, next_x), (conv_bc_state, next_bc),
                         (hstate, next_h)):
            if lanes is not None:
                # inactive lanes write back what they hold (no host sync)
                new = torch.where(lanes.reshape((b,) + (1,) * (new.dim() - 1)),
                                  new, old)
            old.copy_(new)
        new_cache = cache

    # gated RMSNorm (Mamba-2): norm(y * silu(z)), at the reference's
    # default eps
    y = y * _silu(z, y.dtype)
    y = rms_norm(y, p["norm"])
    out = dense(y, p["out_proj"])
    return shard(out, "batch", None, None), new_cache


def mamba_cache_specs(d_model: int, s: SSMConfig, batch: int, dtype):
    """(conv_x_state, conv_bc_state) in the activation type, the SSM state
    in float32."""
    d_in, h, d_bc = ssm_dims(d_model, s)
    w = s.conv_width
    return (
        ParamSpec((batch, d_in, w - 1), dtype, ("batch", "tp", None)),
        ParamSpec((batch, d_bc, w - 1), dtype, ("batch", None, None)),
        ParamSpec((batch, h, s.head_dim, s.state_dim), torch.float32,
                  ("batch", None, None, None)),
    )
