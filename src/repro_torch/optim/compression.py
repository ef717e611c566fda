"""Gradient compression for the DP all-reduce: int8 block quantization with
error feedback — port of ``repro.optim.compression``.

Gradients are quantized in blocks of 2048 values to int8 with one float32
scale a block; the residual (what quantization lost) is carried to the
next step and added before quantizing, which keeps the update unbiased
[Seide et al. 2014; Karimireddy et al. 2019].  Leaves in ``jax.tree``'s
order (``core.tree``)::

    g_q, scales, err = compress_gradients(grads, err)
    grads = decompress_gradients(g_q, scales, grads)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any
_BLOCK = 2048


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape)


def compress_gradients(grads: PyTree, err: Optional[PyTree] = None):
    """Returns (quantized, scales, new_error_feedback)."""
    with torch.no_grad():
        if err is None:
            err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                 device=g.device), grads)
        corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, err)
        leaves, spec = tree_flatten(corrected)
        pairs = [_quantize(l) for l in leaves]
        q = tree_unflatten(spec, [p[0] for p in pairs])
        scales = tree_unflatten(spec, [p[1] for p in pairs])
        deq = tree_map(lambda qq, ss, g: _dequantize(qq, ss, g.shape), q, scales,
                       corrected)
        new_err = tree_map(lambda c, d: c - d, corrected, deq)
    return q, scales, new_err


def decompress_gradients(q: PyTree, scales: PyTree, like: PyTree) -> PyTree:
    with torch.no_grad():
        return tree_map(
            lambda qq, ss, g: _dequantize(qq, ss, g.shape).to(g.dtype),
            q, scales, like)
