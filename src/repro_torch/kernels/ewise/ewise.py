"""EW* on Hopper: the ctypes wrapper around ``csrc/ewise.cu`` and its
launch plan.

Replaces ``repro/kernels/ewise/ewise.py::ewise_pallas``.  One kernel per
(type, op) over the flat operands under :func:`ewise_plan`: items are
16-byte vectors where all three pointers are aligned and single elements
where not, each block covers one contiguous chunk of U items a thread, and
a thread loads all its items of a and b before it computes; the ragged
edge is masked, so the divisor is never padded.  A TuningDB entry may set
the items a thread (:func:`ewise_space`); every plan writes each element
once with the same arithmetic, so the bits do not depend on it.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("ewise")

#: threads a block (csrc/ewise.cu kThreads), and the items a thread may take
THREADS = 256
ITEMS = (4, 1)


class EwisePlan(NamedTuple):
    """How the kernel covers n elements: items of ``item_elems`` elements
    (16 bytes' worth where aligned, else 1), ``items_per_thread`` (U) a
    thread, ``blocks`` blocks of :data:`THREADS`; block g covers items
    g·U·THREADS to (g + 1)·U·THREADS − 1, and the last block also the n mod
    ``item_elems`` elements past the last whole item."""
    item_elems: int
    items_per_thread: int
    blocks: int


def ewise_plan(n: int, dtype: torch.dtype, aligned: bool, sms: int,
               items_per_thread: Optional[int] = None) -> EwisePlan:
    """The launch plan for n ≥ 1 elements of ``dtype``: U = 4 items a thread
    while that still gives every one of ``sms`` SMs a block, else 1; or
    ``items_per_thread`` where a tuned plan gives it.  ``blocks`` follows
    from U."""
    elems = 16 // dtype.itemsize if aligned else 1
    items = n // elems
    u = items_per_thread or next(
        u for u in ITEMS if u == 1 or cdiv(items, u * THREADS) >= sms)
    return EwisePlan(elems, u, max(1, cdiv(items, u * THREADS)))


def ewise_space(a, b, **kw) -> List[Dict[str, Any]]:
    """The launch plans EW*'s hopper rows may be tuned over: U in
    :data:`ITEMS` items a thread, for operands of one or more elements and
    as many in b.  A function of the element count alone; one space serves
    EWMM, EWMD, EWADD and EWSUB."""
    n = getattr(a, "numel", lambda: 0)()
    if n < 1 or getattr(b, "numel", lambda: -1)() != n:
        return []
    return [{"items_per_thread": u} for u in ITEMS]


def check_plan(a, b, items_per_thread: Optional[int]) -> None:
    """Raise unless ``items_per_thread`` is None or one of
    :func:`ewise_space`'s."""
    if items_per_thread is not None and \
            {"items_per_thread": items_per_thread} not in ewise_space(a, b):
        raise ValueError(f"EW*: {items_per_thread} items a thread is not in the "
                         f"tuning space of {tuple(a.shape)} (one of {ITEMS})")

#: op name -> the code the C entry point takes
OPS = {"mul": 0, "div": 1, "add": 2, "sub": 3}


def ewise_problem(a, b) -> Optional[str]:
    """Why the EW* kernel cannot take ``(a, b)``, or None: ``b`` must have
    as many elements as ``a`` (it is read in ``a``'s shape, no
    broadcasting)."""
    why = _cuda.operand_problem((a, b))
    if why:
        return why
    if a.numel() != b.numel():
        return (f"EW* operands differ in size: {tuple(a.shape)} vs "
                f"{tuple(b.shape)} (no broadcasting)")
    return None


def ewise_hopper(a: torch.Tensor, b: torch.Tensor, op: str,
                 items_per_thread: Optional[int] = None) -> torch.Tensor:
    """``a (op) b`` element-wise on the card, in ``a``'s shape and type,
    under :func:`ewise_plan` (at ``items_per_thread``, a tuned plan's U,
    where given)."""
    _cuda.require_cuda(ewise_problem(a, b), f"EW {op}", a)
    check_plan(a, b, items_per_thread)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    vec = _cuda.aligned(a, b, out)
    plan = ewise_plan(a.numel(), a.dtype, vec, _cuda.sm_count(a.device),
                      items_per_thread)
    rc = _cuda.lib().halo_ewise(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.numel(), OPS[op], _cuda.dtype_code(a.dtype), int(vec),
                                plan.items_per_thread, plan.blocks,
                                _cuda.stream(a.device))
    _cuda.check(rc, "ewise")
    LAUNCHES.add()
    return out
