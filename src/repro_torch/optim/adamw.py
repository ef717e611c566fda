"""AdamW with decoupled weight decay and global-norm clipping — port of
``repro.optim.adamw``.

Optimizer moments are float32.  Leaves are taken in ``jax.tree``'s order
(``core.tree``), the update in the reference's float32 arithmetic and op
order, under ``torch.no_grad()``.  The update is functional: it returns
new trees and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: PyTree               # first moment, f32
    nu: PyTree               # second moment, f32


def adamw_init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), each leaf in float32."""
    with torch.no_grad():
        return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                              for l in tree_leaves(tree)))


def adamw_update(params: PyTree, grads: PyTree, state: AdamWState, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0):
    """Returns (new_params, new_state, {"grad_norm"})."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = None
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        b1c = 1.0 - b1 ** step.to(torch.float32)
        b2c = 1.0 - b2 ** step.to(torch.float32)
        lr = torch.as_tensor(lr, dtype=torch.float32)

        def upd(p, g, m, v):
            # the clip, a leaf at a time: bfloat16 × a float32 scale is
            # float32 in the reference (JAX promotes); torch would keep
            # bfloat16 beside a 0-d tensor.  The float32 temporaries of one
            # leaf are alive at a time, and those of its last ops are
            # updated in place (the same values): at full width the
            # largest leaf's are GBs
            g = g.to(torch.float32)
            if scale is not None:
                g = g * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            del g
            delta = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
            delta.add_(weight_decay * p.to(torch.float32))
            return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

        flat_p, spec = tree_flatten(params)
        out = [upd(p, g, m, v) for p, g, m, v in
               zip(flat_p, tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu))]
        new_p = tree_unflatten(spec, [o[0] for o in out])
        new_m = tree_unflatten(spec, [o[1] for o in out])
        new_v = tree_unflatten(spec, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
