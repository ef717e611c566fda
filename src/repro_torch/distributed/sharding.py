"""Logical-axis sharding rules (MaxText-style) — port of
``repro.distributed.sharding``.

Model code names *logical* axes ("batch", "fsdp", "tp", "expert", "seq",
"vocab"); a :class:`ShardingRules` table maps them to the named dims of a
device mesh (a ``torch.distributed`` ``DeviceMesh``, one process a rank:
``repro_torch.launch.mesh``).  :func:`mesh_context` activates a mesh and
rules for the calling thread, as in the reference; without one
:func:`current_context` reports ``mesh=None`` and every rank runs the
one-device path.

The rule for values is a global view.  Outside a ``shard_map`` region
(``repro_torch.distributed.mesh_ops``) every rank holds every tensor
whole, just as each device sees a ``jax.Array``'s global value: a
sharding constraint changes no value in the reference, so :func:`shard`
is the identity here, and :func:`logical_spec` only names the placement.
Inside a region each rank takes its block of each input by the region's
specs and the body's collectives run on the mesh's axis groups.

Parameter storage stays whole on every rank, in training too: every
rank takes the whole batch, holds the whole state and computes the same
update, and the backward through a region's collectives
(``mesh_ops``) hands every rank the whole gradient.  A checkpoint thus
restores onto any mesh or none.  Placing only a rank's blocks (the
reference's ``named_sharding`` and ``ParamSpec.struct``) has one reader,
the dry run (ROADMAP A13), and comes with it.

The partition helpers serve the C²MPI collectives (scatter and elastic
re-layout, DESIGN.md §10–11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Tuple, Union

import torch

Logical = Union[str, None, Tuple[str, ...]]

__all__ = ["Logical", "MeshContext", "ParamSpec", "PartitionSpec",
           "ShardingRules", "current_context", "logical_spec",
           "member_shard", "mesh_axes", "mesh_context", "partition_slices",
           "repartition_shards", "shard", "sp_rules"]


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


def sp_rules() -> ShardingRules:
    """Rules with sequence-parallel residual activations enabled."""
    return ShardingRules(seq_act=("model",))


class PartitionSpec(tuple):
    """One entry per dim: ``None`` (whole), one mesh axis name, or a tuple
    of them (the dim split over their product, row-major) — the port's
    counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """A mesh's named dims → their sizes, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class MeshContext:
    mesh: Optional[Any]        # a torch.distributed DeviceMesh
    rules: ShardingRules

    def axis_size(self, mesh_axes_: Sequence[str]) -> int:
        """Ranks along ``mesh_axes_`` (1 without a mesh; an axis the mesh
        lacks counts 1)."""
        if self.mesh is None:
            return 1
        sizes = mesh_axes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in mesh_axes_)


_tls = threading.local()


def current_context() -> MeshContext:
    """The calling thread's mesh context (no mesh unless
    :func:`mesh_context` set one in this thread)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = MeshContext(mesh=None, rules=ShardingRules())
    return ctx


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[ShardingRules] = None):
    """Activate a mesh and rules for model code in this thread; rule axes
    the mesh does not have (``"pod"`` on a one-pod mesh) are dropped."""
    prev = getattr(_tls, "ctx", None)
    rules = rules or ShardingRules()
    if mesh is not None:
        have = set(mesh.mesh_dim_names)
        rules = ShardingRules(**{
            f.name: tuple(a for a in getattr(rules, f.name) if a in have)
            for f in dataclasses.fields(rules)})
    _tls.ctx = MeshContext(mesh=mesh, rules=rules)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def _dim_entry(ctx: MeshContext, logical: Logical, size: int):
    """One dim's logical name → its spec entry (``None``: whole)."""
    if logical is None:
        return None
    names = (logical,) if isinstance(logical, str) else tuple(logical)
    axes: Tuple[str, ...] = ()
    for n in names:
        axes += ctx.rules.axes_for(n)
    if not axes:
        return None
    if size % ctx.axis_size(axes) != 0:
        return None                  # indivisible → this dim stays whole
    return axes if len(axes) > 1 else axes[0]


def logical_spec(shape: Sequence[int], logical: Sequence[Logical],
                 ctx: Optional[MeshContext] = None) -> PartitionSpec:
    ctx = ctx or current_context()
    assert len(shape) == len(logical), (shape, logical)
    return PartitionSpec(*(_dim_entry(ctx, l, s) for s, l in zip(shape, logical)))


def shard(x, *logical: Logical):
    """A logical sharding constraint: the identity on values (the global
    view); under a mesh the names are resolved, so a wrong count of them
    raises as in the reference."""
    ctx = current_context()
    if ctx.mesh is not None:
        logical_spec(x.shape, logical, ctx)
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
    """Member ``rank``'s shard of ``x`` along ``axis``: a plain slice."""
    start, size = partition_slices(x.shape[axis], parts)[rank]
    return x.narrow(axis, start, size)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Planning record for one parameter or cache tensor."""
    shape: Tuple[int, ...]
    dtype: Any                 # a torch.dtype
    logical: Tuple[Logical, ...]
    init_kind: str = "normal"  # normal | ones | zeros | a_log | dt_bias
