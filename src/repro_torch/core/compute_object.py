"""Unified compute-object (C2MPI §IV-D) — port of
``repro.core.compute_object``.

The compute-object marshals all arguments of a distributed remote procedure
call between parent ranks (PRs) and child ranks (CRs).  Here it is a pytree
over tensors (``torch.utils._pytree``):

* **external** buffers — owned by the application (tensors in ``inputs``),
* **internal** buffers — owned by the framework and addressed by an opaque
  :class:`BufferHandle`; the runtime agent resolves handles to
  device-resident tensors at dispatch time.

:func:`from_numpy` / :func:`to_numpy` carry state across the package
boundary: numpy arrays in (as the JAX package consumes and produces them),
tensors out, and back.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["BufferHandle", "ComputeObject", "as_compute_object", "from_numpy",
           "to_numpy"]

_handle_counter = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class BufferHandle:
    """Opaque handle to a framework-managed (internal) buffer.

    Mirrors the handle returned by ``MPIX_CreateBuffer``: a plain integer id
    plus static metadata; the tensor lives in the runtime agent's buffer
    table and only the handle travels."""

    uid: int
    shape: tuple
    dtype: Any
    owner_rank: int  # CR uid that owns the state (0 = framework-global)

    @staticmethod
    def allocate(shape, dtype, owner_rank: int = 0) -> "BufferHandle":
        return BufferHandle(next(_handle_counter), tuple(shape), dtype, owner_rank)


@dataclasses.dataclass
class ComputeObject:
    """Unified compute-object: named external inputs + internal buffer refs.

    ``inputs`` are pytree leaves; ``buffers`` and ``meta`` are static
    context.  ``tag`` implements the C2MPI out-of-order retrieval semantics
    (repeated sends with one tag behave FIFO per tag)."""

    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    buffers: Dict[str, BufferHandle] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tag: int = 0

    @property
    def stateful(self) -> bool:
        """Stateful RPC = at least one internal buffer attached (§IV-D)."""
        return bool(self.buffers)

    def with_input(self, name: str, value) -> "ComputeObject":
        """A new compute-object with ``inputs[name] = value``; this one is
        left as it was."""
        new = dict(self.inputs)
        new[name] = value
        return dataclasses.replace(self, inputs=new)

    def with_buffer(self, name: str, handle: BufferHandle) -> "ComputeObject":
        """A new compute-object with ``buffers[name] = handle``; this one
        is left as it was."""
        new = dict(self.buffers)
        new[name] = handle
        return dataclasses.replace(self, buffers=new)

    def working_set_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in pytree.tree_leaves(self.inputs)
                   if isinstance(leaf, torch.Tensor))


def _flatten(co: ComputeObject):
    names = tuple(sorted(co.inputs))
    context = (names, tuple(sorted(co.buffers.items())),
               tuple(sorted(co.meta.items())), co.tag)
    return [co.inputs[n] for n in names], context


def _unflatten(leaves, context) -> ComputeObject:
    names, buffers, meta, tag = context
    return ComputeObject(inputs=dict(zip(names, leaves)), buffers=dict(buffers),
                         meta=dict(meta), tag=tag)


pytree.register_pytree_node(ComputeObject, _flatten, _unflatten)


def as_compute_object(obj, tag: int = 0) -> ComputeObject:
    """Coerce plain tensors / dicts / tuples into a compute-object.

    Implements the paper's *single-input optimization*: simple payloads may be
    passed as one would with traditional MPI, skipping explicit encapsulation.
    """
    if isinstance(obj, ComputeObject):
        return obj
    if isinstance(obj, dict):
        return ComputeObject(inputs=dict(obj), tag=tag)
    if isinstance(obj, (tuple, list)):
        return ComputeObject(inputs={f"arg{i:03d}": v for i, v in enumerate(obj)},
                             tag=tag)
    return ComputeObject(inputs={"arg000": obj}, tag=tag)


# ---------------------------------------------------------------------------
# numpy <-> tensor state transfer
# ---------------------------------------------------------------------------
def _array_to_tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX hands out ml_dtypes arrays.
        # The bits go through a uint16 view, so no ml_dtypes import is needed.
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device)


def _tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.uint16).numpy()
    try:
        # registered by ml_dtypes when a package that uses it (JAX) is loaded
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        return t.float().numpy()    # exact widening when numpy has no bf16


def from_numpy(tree, device="cpu"):
    """Every numpy array (or numpy scalar) leaf of ``tree`` → a tensor on
    ``device``; other leaves pass through.  bfloat16 arrays keep their bits."""
    def conv(leaf):
        if isinstance(leaf, (np.ndarray, np.generic)):
            return _array_to_tensor(np.asarray(leaf), device)
        return leaf
    return pytree.tree_map(conv, tree)


def to_numpy(tree):
    """Every tensor leaf of ``tree`` → a host numpy array; other leaves pass
    through.  A bfloat16 tensor becomes a numpy bfloat16 array when numpy
    knows that dtype (ml_dtypes loaded), else an exactly widened float32
    array."""
    return pytree.tree_map(
        lambda leaf: _tensor_to_array(leaf) if isinstance(leaf, torch.Tensor)
        else leaf, tree)
