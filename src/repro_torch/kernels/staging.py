"""Data-movement aliases (DESIGN.md §10) — port of ``repro.kernels.staging``.

* ``COPY``   — identity staging: materializes a value on the agent that
  executes it; the graph fusion pass (§12) fuses it as a unary step.
* ``CONCAT`` — variadic shard concatenation along axis 0 (0-d shards stack
  into a vector, one element per shard).

Neither has a TPU kernel to port: the reference's rows are ``jnp`` calls and
one jitted copy.  Every row of CONCAT is one ATen concatenation; COPY's
oracle passes its value through and its ``aten`` and ``hopper`` rows copy
it into a fresh tensor.
"""
from __future__ import annotations

import torch

__all__ = ["concat_ref", "copy_ref", "copy_stage"]


def copy_ref(x):
    """Identity staging oracle (COPY fail-safe)."""
    return torch.as_tensor(x)


def copy_stage(x):
    """Identity staging into a fresh tensor on the executing agent's
    stream."""
    return torch.as_tensor(x).clone()


def concat_ref(*parts):
    """Gather combine: concatenate shards along axis 0 (one ATen call, and
    the CONCAT fail-safe); 0-d shards stack into a vector."""
    if getattr(parts[0], "ndim", 0) == 0:
        return torch.stack(parts)
    return torch.cat(parts, dim=0)
