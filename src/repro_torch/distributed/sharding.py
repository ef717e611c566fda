"""Logical-axis sharding rules — port of ``repro.distributed.sharding`` for
one device.

Model code names *logical* axes ("batch", "fsdp", "tp", "seq", "vocab") as
in the reference.  The port runs on one card, so there is never a mesh:
:func:`current_context` reports ``mesh=None`` and :func:`shard` is the
identity.  The partition helpers serve the collectives (C²MPI scatter and
elastic re-layout, DESIGN.md §10–11).  Data-parallel training runs over
C²MPI device groups and needs no mesh; the mesh, ``mesh_context`` and
``named_sharding`` come with their first reader, the expert-sharded MoE
(ROADMAP A10c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

import torch

Logical = Union[str, None, Tuple[str, ...]]

__all__ = ["Logical", "MeshContext", "ParamSpec", "ShardingRules",
           "current_context", "member_shard", "partition_slices",
           "repartition_shards", "shard"]


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


def partition_slices(length: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """Equal ``(start, size)`` slices of a ``length`` axis over ``parts``
    group members (C²MPI scatter semantics, DESIGN.md §10).  Like
    ``MPI_Scatter``, the axis must divide evenly: the uneven v-variant is
    not implemented."""
    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    if length % parts != 0:
        raise ValueError(
            f"scatter axis of size {length} does not divide evenly over "
            f"{parts} group members (MPIX_Scatterv is not implemented)")
    size = length // parts
    return tuple((r * size, size) for r in range(parts))


def repartition_shards(shards: Sequence[torch.Tensor], parts: int,
                       axis: int = 0) -> Tuple[torch.Tensor, ...]:
    """Re-split per-member shards from one group layout into ``parts`` equal
    shards (elastic membership change, DESIGN.md §11): concatenate along
    ``axis`` and re-slice with :func:`partition_slices`.  Pure data
    movement (each shard a fresh contiguous copy), so carried loop state
    keeps its values; only later reductions see another bracketing."""
    arrs = [torch.as_tensor(s) for s in shards]
    if not arrs:
        raise ValueError("repartition_shards needs at least one shard")
    full = arrs[0] if len(arrs) == 1 else torch.cat(arrs, dim=axis)
    return tuple(full.narrow(axis, start, size).clone(
                     memory_format=torch.contiguous_format)
                 for start, size in partition_slices(full.shape[axis], parts))


def member_shard(x: torch.Tensor, rank: int, parts: int,
                 axis: int = 0) -> torch.Tensor:
    """Member ``rank``'s shard of ``x`` along ``axis``: a plain slice, since
    the port has no mesh."""
    start, size = partition_slices(x.shape[axis], parts)[rank]
    return x.narrow(axis, start, size)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Planning record for one parameter or cache tensor."""
    shape: Tuple[int, ...]
    dtype: Any                 # a torch.dtype
    logical: Tuple[Logical, ...]
    init_kind: str = "normal"  # normal | ones | zeros | a_log | dt_bias
