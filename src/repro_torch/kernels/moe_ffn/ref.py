"""Plain PyTorch oracle for MOE_FFN (grouped per-expert gated FFN) — port
of ``repro.kernels.moe_ffn.ref``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def per_expert(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,K) @ (E,K,N) as E separate 2-D products of one shape, one
    expert at a time: an expert's bits depend on its own rows and weights
    only, never on how many experts the call holds.  cuBLAS's float32
    batched product sums in another order by batch count at a few rows a
    batch (ROADMAP C3: 64 experts at C = 4 against four slices of 16), so
    the float32 MOE_FFN rows take this form; the 16-bit types keep the
    batched product, whose bits hold across slices at C = 4 and 244."""
    return torch.stack([torch.mm(x[i], w[i]) for i in range(x.shape[0])])


def _products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return per_expert(x, w) if x.dtype == torch.float32 else torch.matmul(x, w)


def grouped_ffn_ref(xe, w_gate, w_up, w_down):
    """xe (E,C,D) dispatched tokens; w_gate/w_up (E,D,F); w_down (E,F,D).

    Per-expert SwiGLU FFN over each expert's capacity slots, every product
    in the input type: h and u are rounded to it, silu runs in float32 and
    is cast back, then the down product.  Float32 products run one expert
    at a time (:func:`per_expert`)."""
    h = _products(xe, w_gate)
    u = _products(xe, w_up)
    act = F.silu(h.float()).to(h.dtype) * u
    return _products(act, w_down)
