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

This is the ``aten`` row.  There is no ``hopper`` row: the reference
registers no Pallas MOE_FFN, and the port adds no kernel the JAX package
lacks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import per_expert


def _f32_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,D) @ (E,D,F) as float32 products of x's and w's values."""
    if x.dtype == torch.float32:
        return per_expert(x, w.float())
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        return torch.bmm(x, w, out_dtype=torch.float32)
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
