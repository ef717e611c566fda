"""Plain PyTorch oracle for MOE_FFN (grouped per-expert gated FFN) — port
of ``repro.kernels.moe_ffn.ref``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_ffn_ref(xe, w_gate, w_up, w_down):
    """xe (E,C,D) dispatched tokens; w_gate/w_up (E,D,F); w_down (E,F,D).

    Per-expert SwiGLU FFN over each expert's capacity slots, every product
    in the input type: h and u are rounded to it, silu runs in float32 and
    is cast back, then the down product."""
    h = torch.matmul(xe, w_gate)
    u = torch.matmul(xe, w_up)
    act = F.silu(h.float()).to(h.dtype) * u
    return torch.matmul(act, w_down)
