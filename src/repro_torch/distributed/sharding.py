"""Logical-axis sharding rules — port of ``repro.distributed.sharding`` for
one device.

Model code names *logical* axes ("batch", "fsdp", "tp", "seq", "vocab") as
in the reference.  The port runs on one card, so there is never a mesh:
:func:`current_context` reports ``mesh=None`` and :func:`shard` is the
identity.  The mesh, ``mesh_context`` and the partition helpers come with
the collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

Logical = Union[str, None, Tuple[str, ...]]

__all__ = ["Logical", "MeshContext", "ParamSpec", "ShardingRules",
           "current_context", "shard"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis → tuple of mesh axes (the reference's defaults)."""
    batch: Tuple[str, ...] = ("pod", "data")
    fsdp: Tuple[str, ...] = ("pod", "data")
    tp: Tuple[str, ...] = ("model",)
    expert: Tuple[str, ...] = ("model",)
    seq: Tuple[str, ...] = ("model",)
    vocab: Tuple[str, ...] = ("model",)
    seq_act: Tuple[str, ...] = ()

    def axes_for(self, name: str) -> Tuple[str, ...]:
        return getattr(self, name)


@dataclasses.dataclass
class MeshContext:
    mesh: Optional[Any]
    rules: ShardingRules

    def axis_size(self, mesh_axes: Sequence[str]) -> int:
        """Devices along ``mesh_axes``: 1 without a mesh."""
        return 1


_CONTEXT = MeshContext(mesh=None, rules=ShardingRules())


def current_context() -> MeshContext:
    """The active mesh context: always one device, no mesh."""
    return _CONTEXT


def shard(x, *logical: Logical):
    """A logical sharding constraint: the identity on one device."""
    return x


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Planning record for one parameter or cache tensor."""
    shape: Tuple[int, ...]
    dtype: Any                 # a torch.dtype
    logical: Tuple[Logical, ...]
    init_kind: str = "normal"  # normal | ones | zeros | a_log | dt_bias
