"""Shared layers: projections, norms, RoPE, activations, embeddings — port
of ``repro.models.layers``.

All matmul-shaped work and every norm dispatch through HALO aliases;
sharding names logical axes (a no-op on one device).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.c2mpi import halo_dispatch
from ..distributed.sharding import shard


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ w (D, F) via the MMM alias (f32 accumulation).  The
    kernels take contiguous operands, and a row slice such as x[:, -1:]
    is not one."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    y = halo_dispatch("MMM", x2, w.to(x.dtype))
    return y.reshape(*shape[:-1], w.shape[-1])


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return halo_dispatch("RMSNORM", x, gamma, eps=eps)


def act_fn(name: str, gate: torch.Tensor, up: Optional[torch.Tensor] = None):
    if name == "swiglu":
        return F.silu(gate.float()).to(gate.dtype) * up
    if name == "geglu":
        return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
    if name == "gelu":
        return F.gelu(gate.float(), approximate="tanh").to(gate.dtype)
    raise ValueError(name)


def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (gelu) FFN."""
    if act in ("swiglu", "geglu"):
        g = shard(dense(x, params["wg"]), "batch", None, "tp")
        u = shard(dense(x, params["wu"]), "batch", None, "tp")
        h = act_fn(act, g, u)
    else:
        h = act_fn(act, shard(dense(x, params["wu"]), "batch", None, "tp"))
    return shard(dense(h, params["wd"]), "batch", None, None)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, NeoX half-rotation.  x (B,S,H,dh), positions (B,S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class EmbedFunction(torch.autograd.Function):
    """The row gather ``embed[tokens]`` whose backward is the EMBED_GRAD
    alias: each table row's sum of its positions' gradient rows in a fixed
    order (stable token order, float32), so a training step's gradients
    repeat bit for bit on the card, where the gather's own backward adds
    with atomics (``kernels/embed_grad/ref.py``).  Every position counts,
    masked and padding ones too, as in the reference's scatter-add."""

    @staticmethod
    def forward(ctx, embed, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = embed.shape[0]
        return embed[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        grad = halo_dispatch("EMBED_GRAD", g.contiguous(), tokens.contiguous(),
                             ctx.vocab)
        return grad, None


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: rows of the (V, D) table.  With grad on and a
    table that requires it, through :class:`EmbedFunction`."""
    if torch.is_grad_enabled() and embed.requires_grad:
        return EmbedFunction.apply(embed, tokens)
    return embed[tokens]


def logits_from_hidden(unembed: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h (..., D) @ unembed (D, V)."""
    return shard(dense(h, unembed), "batch", None, "vocab")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of (..., V) logits against integer labels, in float32:
    (the mask-weighted mean over max(Σw, 1), or the plain mean; the
    per-token nll).  The max is held constant under differentiation; the
    label's logit is picked by ``gather``, which gives the reference's
    one-hot einsum's value and gradient."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        w = mask.float()
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0), nll
    return nll.mean(), nll
