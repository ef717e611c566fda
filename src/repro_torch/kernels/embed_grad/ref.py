"""Plain PyTorch versions of EMBED_GRAD, the gradient of an embedding
lookup ``table[tokens]``: each table row's sum of the gradient rows of the
positions that hold its token.

There is no Pallas site behind it.  The reference's lookup is ``jnp.take``
(``src/repro/models/layers.py:68``), whose VJP is an XLA scatter-add that
adds in a fixed order on the TPU and on the CPU; PyTorch's backward of
``table[tokens]`` adds a repeated token's rows with atomics on the card,
in no fixed order.  :func:`embed_grad_ref` fixes the order, and the kernel
(``csrc/embed_grad.cu``) adds in the same one:

* positions are sorted by token with a stable sort, so each token's
  positions stay in position order (:func:`token_order`);
* the sorted list is cut into chunks of :data:`CHUNK` entries at fixed
  offsets; a *piece* is one token's run inside one chunk, summed in
  sorted order from 0;
* each token's row is 0 plus its pieces in order; a token that does not
  occur gets a zero row.

Every sum is in float32, whatever the table's type, and the row is
rounded to the table's type once.  float32 keeps the reduced float32
models' gradients at the reference's (which adds in the table's type, in
position order) within the parity tolerance, and a bfloat16 table's
gradient is not rounded at every add.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: sorted entries a chunk: ``kChunk`` of ``csrc/embed_grad.cu``
CHUNK = 32


def token_order(tokens: torch.Tensor, vocab: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, sorted_tok, bounds), int32 on ``tokens``' device: the
    positions of the flattened ``tokens`` in stable token order, their
    tokens, and each token's first sorted entry (``bounds[vocab]`` = n)."""
    tok = tokens.reshape(-1).to(torch.int32)
    sorted_tok, perm = torch.sort(tok, stable=True)
    bounds = torch.searchsorted(
        sorted_tok, torch.arange(vocab + 1, dtype=torch.int32, device=tok.device),
        out_int32=True)
    return perm.to(torch.int32), sorted_tok, bounds


def embed_grad_ref(g: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The (vocab, D) gradient of ``table[tokens]`` for the output gradient
    ``g`` (``tokens.shape`` + (D,)), in g's type: the kernel's order and
    float32 roundings, so the two agree to the bit (the fail-safe)."""
    d = g.shape[-1]
    g2 = g.reshape(-1, d)
    n = g2.shape[0]
    dev = g.device
    out = torch.zeros((vocab, d), dtype=torch.float32, device=dev)
    if n:
        perm, sorted_tok, _ = token_order(tokens, vocab)
        idx = torch.arange(n, device=dev)
        first_of_piece = idx % CHUNK == 0
        first_of_piece[1:] |= sorted_tok[1:] != sorted_tok[:-1]
        piece = torch.cumsum(first_of_piece.to(torch.int64), 0) - 1
        first = idx[first_of_piece]                 # each piece's first entry
        offset = idx - first[piece]
        vals = g2[perm.long()].to(torch.float32)
        partial = torch.zeros((first.numel(), d), dtype=torch.float32, device=dev)
        for k in range(min(CHUNK, n)):              # each piece's k-th entry
            at = idx[offset == k]
            partial[piece[at]] += vals[at]
        ptok = sorted_tok[first].long()
        new_token = torch.ones_like(ptok, dtype=torch.bool)
        new_token[1:] = ptok[1:] != ptok[:-1]
        pidx = torch.arange(ptok.numel(), device=dev)
        rank = pidx - torch.cummax(torch.where(new_token, pidx, 0), 0).values
        for r in range(int(rank.max()) + 1):        # each token's r-th piece
            at = rank == r
            out[ptok[at]] += partial[at]
    return out.to(g.dtype)


def embed_grad_aten(g: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The library row: one ``index_put_(accumulate=True)`` into zeros in
    g's type, PyTorch's own backward of ``table[tokens]`` (on the card it
    adds with atomics, in no fixed order)."""
    d = g.shape[-1]
    out = torch.zeros((vocab, d), dtype=g.dtype, device=g.device)
    return out.index_put_((tokens.reshape(-1).long(),), g.reshape(-1, d), accumulate=True)
