"""The library row of MOE_FFN — port of ``repro.kernels.moe_ffn.ops``.

Three batched products over experts: h and u as float32 products of the
input-type operands (bfloat16 × bfloat16 is exact in float32, so only the
sum order differs from the reference's ``preferred_element_type``
einsums), ``silu(h)·u`` in float32 cast to xe's type, then the down product
in xe's type.  On a CUDA tensor of a 16-bit type the float32 products come
from ``torch.bmm(..., out_dtype=torch.float32)``, which reads the weights as
they are stored; elsewhere the operands are widened first.  In float32
the three products run one expert at a time (``ref.per_expert``), so an
expert's bits do not depend on how many experts a call holds (ROADMAP C3:
cuBLAS's float32 batched product sums in another order by batch count);
the 16-bit types keep the batched products.

``bmm(..., out_dtype=torch.float32)`` has no derivative in torch (ROADMAP
C4: a bfloat16 MoE step on the card could not take its backward), so that
product runs as :class:`F32Product`, whose backward is the VJP of the
reference's ``preferred_element_type=float32`` einsum: dx = g·wᵀ and dw =
xᵀ·g from the float32 cotangent, each rounded once to its operand's type,
as the widened path's backward rounds (:func:`f32_product_vjp`).

This is the ``aten`` row.  There is no ``hopper`` row: the reference
registers no Pallas MOE_FFN, and the port adds no kernel the JAX package
lacks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import per_expert


def f32_product_vjp(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(dx, dw) of the float32 product x @ w for its float32 cotangent
    ``g``: float32 products of g with the widened operands, each rounded
    once to its operand's type."""
    dx = torch.bmm(g, w.float().transpose(1, 2)).to(x.dtype)
    dw = torch.bmm(x.float().transpose(1, 2), g).to(w.dtype)
    return dx, dw


class F32Product(torch.autograd.Function):
    """(E,C,D) @ (E,D,F) of 16-bit CUDA operands as a float32 product
    (``bmm`` with ``out_dtype``, which reads the operands as stored), with
    :func:`f32_product_vjp` as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return f32_product_vjp(x, w, g.float())


def _f32_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,D) @ (E,D,F) as float32 products of x's and w's values."""
    if x.dtype == torch.float32:
        return per_expert(x, w.float())
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        return F32Product.apply(x, w)
    return torch.bmm(x.float(), w.float())


def grouped_ffn(xe, w_gate, w_up, w_down):
    """xe (E,C,D); w_gate/w_up (E,D,F); w_down (E,F,D) → (E,C,D) in xe's
    type."""
    h = _f32_products(xe, w_gate)
    u = _f32_products(xe, w_up)
    act = (F.silu(h) * u).to(xe.dtype)
    if xe.dtype == torch.float32:
        return per_expert(act, w_down)
    return torch.bmm(act, w_down)
