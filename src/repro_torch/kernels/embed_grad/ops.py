"""Public EMBED_GRAD: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .embed_grad import embed_grad_hopper, embed_grad_problem
from .ref import embed_grad_ref


def embed_grad(g, tokens, vocab):
    """The (vocab, D) gradient of ``table[tokens]`` for the output gradient
    ``g``: float32 sums in a fixed order, in g's type."""
    if g.device.type == "cpu" and tokens.device.type == "cpu":
        _cuda.require(embed_grad_problem(g, tokens, vocab), "EMBED_GRAD")
        return embed_grad_ref(g, tokens, vocab)
    return embed_grad_hopper(g, tokens, vocab)


def embed_grad_supported(g, tokens, vocab, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return embed_grad_problem(g, tokens, vocab) is None
