"""Public FLASH_ATTN: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors; differentiable through ``mea_attention``'s VJP."""
from __future__ import annotations

import torch

from .. import _cuda
from .flash_attention import flash_attention_hopper, flash_attention_problem
from .ref import attention_ref
from .xla import mea_attention


def _attention(q, k, v, causal, window, prefix_len):
    if all(t.device.type == "cpu" for t in (q, k, v)):
        _cuda.require(flash_attention_problem(q, k, v), "FLASH_ATTN")
        return attention_ref(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len)
    return flash_attention_hopper(q, k, v, causal=causal, window=window,
                                  prefix_len=prefix_len)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention whose backward is the VJP of :func:`mea_attention` at the
    real head dim (the reference's ``_fa_diff``: a recompute-based flash
    backward, no (Sq, Skv) score matrix).  The kernel wrapper's head-dim
    padding stays inside the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, prefix_len)
        return _attention(q, k, v, causal, window, prefix_len)

    @staticmethod
    def backward(ctx, g):
        causal, window, prefix_len = ctx.mask
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = mea_attention(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    prefix_len: int = 0):
    """Online-softmax GQA attention, q (B,H,Sq,D), k/v (B,Hkv,Skv,D): the
    causal, sliding-window and prefix-LM masks of the reference, query i at
    position Skv − Sq + i, scale D^-1/2.

    CPU tensors take the plain version (:func:`attention_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback.  With
    grad enabled and an operand that requires it, the call goes through
    :class:`FlashAttentionFunction`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window, prefix_len)
    return _attention(q, k, v, causal, window, prefix_len)


def flash_attention_supported(q, k, v, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return flash_attention_problem(q, k, v) is None
