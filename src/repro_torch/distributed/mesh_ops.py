"""``shard_map`` and the collectives its bodies call, over a
``torch.distributed`` ``DeviceMesh`` — the port's counterparts of
``jax.shard_map`` and the ``jax.lax`` verbs the reference's MoE bodies use.

Under the global view (``repro_torch.distributed.sharding``) every rank
holds each input whole.  :func:`shard_map` gives the body the rank's block
of each input by its spec (the rank's coordinates on the mesh; a dim split
over several axes is split over their product, row-major), runs the body,
and puts each output back together by an all-gather over its spec's axes;
a ``P()`` output is returned as the body made it (the reference's
``check_vma=False``: the body makes it equal on every rank).

The verbs:

* :func:`all_to_all` — ``jax.lax.all_to_all(tiled=True)``:
  ``all_to_all_single`` on the axis group; the split axis is cut into one
  chunk a rank and the chunks received are concatenated along the concat
  axis in rank order.
* :func:`all_gather` — ``jax.lax.all_gather(tiled=True)``: ``all_gather``
  (a list a rank) concatenated along the axis.
* :func:`psum` / :func:`pmean` — ``all_reduce`` SUM (divided by the size).
* :func:`axis_index` — ``mesh.get_local_rank(axis)``.

A group over one axis is the mesh's own; a group over several axes is the
world when they cover the mesh, else one set of subgroups made once per
mesh and axes.  Every rank must reach each verb in the same order, as in
an SPMD program.  A verb over one rank returns its input.  Each verb adds
the bytes this rank hands it to :data:`BYTES_SENT` under its name.

**The backward** is the transpose the reference's ``shard_map`` takes
with ``check_vma=False`` (``jax._src.shard_map._shard_map_transpose``).
Each verb and each half of :func:`shard_map` is an ``autograd.Function``
that saves its mesh, axes and specs at the forward; a backward never
reads the thread-local context (on the card autograd runs it on its own
device thread):

* an output's reassembly — this rank's own block of the cotangent (every
  rank holds it whole: the global view), divided by the ranks along the
  mesh axes the output's spec leaves out, over which the output is
  replicated; no collective (a reduce-scatter would add the same
  cotangent n times);
* :func:`psum` — a sum of the cotangent over the same axes (JAX's psum
  transposes to a psum); :func:`pmean` divides that by n;
* :func:`all_to_all` — the inverse exchange, split and concat swapped;
* :func:`all_gather` inside a body — the cotangent summed over its axes,
  then this rank's block (a reduce-scatter);
* an input's block (:func:`block_of`) — the cotangent summed over the
  mesh axes the spec leaves out, then gathered over the axes it splits,
  so every rank holds the whole gradient.

Together they give the gradient of the global function: an output made
equal across an axis by a psum carries the cotangent over n into each
term and the psum adds the n copies back, and one made equal by
computing the same thing on every rank of the axis counts it once.  A
backward verb counts its bytes in :data:`BYTES_SENT` under the forward's
verb names.

Only verbs that exist in every supported torch are used (no
``all_gather_into_tensor``, no ``all_gather_single``).  The backend is
the process group's own, and no verb is staged through host memory here:
``gloo`` takes CUDA tensors for every verb used (``all_to_all_single`` in
int8, bfloat16 and float32, ``all_gather``, ``all_reduce`` of a 0-d
tensor and of bfloat16 and float32 gradients: checked with two and four
ranks on one H100) and copies them through the
host itself; ``nccl`` keeps them on the cards.  Nothing here switches
backend or device on an error.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import PartitionSpec, mesh_axes

__all__ = ["BYTES_SENT", "all_gather", "all_to_all", "axis_index",
           "block_of", "group_of", "pmean", "psum", "shard_map"]

#: verb → bytes this process handed to it (a verb over one rank: none)
BYTES_SENT: collections.Counter = collections.Counter()

#: (id(mesh), axes) → (mesh, this rank's group over those axes); the mesh
#: is kept so its id is not reused
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_order(mesh, axes: Tuple[str, ...]) -> None:
    names = list(mesh.mesh_dim_names)
    unknown = [a for a in axes if a not in names]
    if unknown:
        raise ValueError(f"axes {unknown} are not dims of the mesh {names}")
    if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}: "
                         f"a dim split over them would not be row-major")


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _size(mesh, axes: Sequence[str]) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def _index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's row-major block index over ``axes``."""
    sizes, idx = mesh_axes(mesh), 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def group_of(mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along ``axes``; group rank
    order is the row-major order over ``axes`` (axes in mesh order)."""
    axes = tuple(axes)
    _check_order(mesh, axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if len(axes) == len(mesh.mesh_dim_names) and \
            mesh.mesh.flatten().tolist() == list(range(dist.get_world_size())):
        return dist.group.WORLD
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh.permute(
            *[names.index(a) for a in names if a not in axes],
            *[names.index(a) for a in axes])
        ranks = ranks.reshape(-1, _size(mesh, axes)).tolist()
        mine, _ = dist.new_subgroups_by_enumeration(ranks)
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def _exchange(x: torch.Tensor, mesh, axis: str, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    n = _size(mesh, (axis,))
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis of size {x.shape[split_axis]} does not "
                         f"divide over the {n} ranks of {axis!r}")
    moved = x.movedim(split_axis, 0)
    send = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    BYTES_SENT["all_to_all"] += send.numel() * send.element_size()
    dist.all_to_all_single(recv, send, group=group_of(mesh, (axis,)))
    return torch.cat([recv[r].movedim(0, split_axis) for r in range(n)],
                     dim=concat_axis)


def _gather(x: torch.Tensor, mesh, axes: Sequence[str], axis: int) -> torch.Tensor:
    n = _size(mesh, axes)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    BYTES_SENT["all_gather"] += x.numel() * x.element_size()
    dist.all_gather(parts, x, group=group_of(mesh, axes))
    return torch.cat(parts, dim=axis)


def _sum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    if _size(mesh, axes) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    BYTES_SENT["all_reduce"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group_of(mesh, axes))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _exchange(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return _exchange(g, mesh, axis, concat_axis, split_axis), None, None, None, None


class _AllGather(torch.autograd.Function):
    """A gather inside a body; backward: every rank's cotangent for this
    rank's block, summed (JAX's all_gather transposes to psum_scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.args = (mesh, axes, axis, x.shape[axis])
        return _gather(x, mesh, axes, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, axis, size = ctx.args
        g = _sum(g, mesh, axes)
        return g.narrow(axis, _index(mesh, axes) * size, size), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _sum(g, mesh, axes), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all_to_all along ``axis``: chunk r of ``split_axis`` goes to
    rank r; the chunks received are concatenated along ``concat_axis`` in
    rank order.  Backward: the inverse exchange."""
    if _size(mesh, (axis,)) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str],
               axis: int) -> torch.Tensor:
    """Tiled all_gather over ``axes``: every rank's block concatenated
    along ``axis`` in row-major order.  Backward (inside a body, where
    every rank's cotangent differs): a sum over ``axes`` of the
    cotangent, then this rank's block."""
    if _size(mesh, axes) == 1:
        return x
    return _AllGather.apply(x, mesh, tuple(axes), axis)


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over the ranks along ``axes`` (a new tensor).  Backward: the
    same sum of the cotangent."""
    if _size(mesh, axes) == 1:
        return x
    return _Psum.apply(x, mesh, tuple(axes))


def pmean(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Mean over the ranks along ``axes``.  Backward: psum's, over n."""
    n = _size(mesh, axes)
    return x if n == 1 else psum(x, mesh, axes) / n


def _split_dims(mesh, spec: PartitionSpec, ndim: int):
    """(dim, axes) of every dim ``spec`` splits, checked against the mesh."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor has "
                         f"dims ({ndim})")
    out = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            _check_order(mesh, axes)
            out.append((dim, axes))
    return out


def _narrow(x: torch.Tensor, mesh, splits) -> torch.Tensor:
    for dim, axes in splits:
        n = _size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over the {n} ranks of {axes}")
        size = x.shape[dim] // n
        x = x.narrow(dim, _index(mesh, axes) * size, size)
    return x


class _Block(torch.autograd.Function):
    """An input's block; backward: the cotangent summed over the axes the
    spec leaves out, then gathered over those it splits."""

    @staticmethod
    def forward(ctx, x, mesh, splits):
        ctx.args = (mesh, splits)
        return _narrow(x, mesh, splits)

    @staticmethod
    def backward(ctx, g):
        mesh, splits = ctx.args
        split = {a for _, axes in splits for a in axes}
        g = _sum(g, mesh, tuple(a for a in mesh.mesh_dim_names if a not in split))
        for dim, axes in splits:
            g = _gather(g, mesh, axes, dim)
        return g, None, None


class _Unblock(torch.autograd.Function):
    """An output put back together; backward: this rank's own block of the
    cotangent over ``copies``, the ranks along the axes the spec leaves
    out."""

    @staticmethod
    def forward(ctx, x, mesh, splits, copies):
        ctx.args = (mesh, splits, copies)
        for dim, axes in splits:
            x = _gather(x, mesh, axes, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, splits, copies = ctx.args
        return _narrow(g, mesh, splits) / copies, None, None, None


def block_of(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``."""
    return _Block.apply(x, mesh, _split_dims(mesh, spec, x.ndim))


def _unblock(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    splits = _split_dims(mesh, spec, x.ndim)
    split = {a for _, axes in splits for a in axes}
    copies = _size(mesh, [a for a in mesh.mesh_dim_names if a not in split])
    return _Unblock.apply(x, mesh, splits, copies) if splits or copies > 1 else x


def shard_map(fn: Callable, mesh, in_specs: Sequence[PartitionSpec],
              out_specs: Sequence[PartitionSpec]) -> Callable:
    """``fn`` run on each rank's blocks; its outputs put back together."""
    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} specs")
        outs = fn(*(block_of(a, mesh, s) for a, s in zip(args, in_specs)))
        return tuple(_unblock(o, mesh, s) for o, s in zip(outs, out_specs))
    return run
