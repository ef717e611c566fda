"""EMBED_GRAD on Hopper: the ctypes wrapper around ``csrc/embed_grad.cu``.

Replaces no Pallas kernel: it is the card's deterministic backward of an
embedding lookup (``ref.py`` says why).  The wrapper does the index
bookkeeping with PyTorch's integer ops (:func:`ref.token_order`: a stable
sort of the positions by token and each token's first sorted entry); the
kernel does every float sum, chunk by chunk and then row by row, and
writes the whole (vocab, D) gradient once.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from .ref import token_order

LAUNCHES = _cuda.counter("embed_grad")

_INDEX_DTYPES = (torch.int32, torch.int64)


def embed_grad_problem(g, tokens, vocab) -> Optional[str]:
    """Why the EMBED_GRAD kernel cannot take ``(g, tokens, vocab)``, or None."""
    why = _cuda.operand_problem((g,))
    if why:
        return why
    if not isinstance(tokens, torch.Tensor) or tokens.dtype not in _INDEX_DTYPES:
        return "the tokens must be an int32 or int64 tensor"
    if tokens.device != g.device:
        return f"the tokens lie on {tokens.device}, the gradient on {g.device}"
    if g.dim() < 1 or tuple(g.shape[:-1]) != tuple(tokens.shape):
        return (f"the gradient {tuple(g.shape)} must be the tokens' shape "
                f"{tuple(tokens.shape)} plus one axis")
    if not isinstance(vocab, int) or vocab < 1 or g.shape[-1] < 1:
        return f"EMBED_GRAD needs vocab >= 1 and D >= 1, got {vocab}, {g.shape[-1]}"
    if tokens.numel() >= 2 ** 31 or vocab >= 2 ** 31 or g.shape[-1] >= 2 ** 24:
        return "EMBED_GRAD takes fewer than 2^31 positions and tokens and 2^24 columns"
    return None


def embed_grad_hopper(g: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The (vocab, D) gradient of ``table[tokens]`` on the card, in g's type."""
    _cuda.require_cuda(embed_grad_problem(g, tokens, vocab), "EMBED_GRAD", g)
    d = g.shape[-1]
    g2 = g.reshape(-1, d).contiguous()
    n = g2.shape[0]
    perm, sorted_tok, bounds = token_order(tokens, vocab)
    partial = torch.empty((n, d), dtype=torch.float32, device=g.device)
    out = torch.empty((vocab, d), dtype=g.dtype, device=g.device)
    rc = _cuda.lib().halo_embed_grad(
        g2.data_ptr(), perm.data_ptr(), sorted_tok.data_ptr(), bounds.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, d, vocab, _cuda.dtype_code(g.dtype),
        _cuda.stream(g.device))
    _cuda.check(rc, "embed_grad")
    LAUNCHES.add()
    return out
