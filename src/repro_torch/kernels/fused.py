"""Fused chains for the graph fusion pass (DESIGN.md §12) — port of
``repro.kernels.fused``.

The fusion pass (:mod:`repro_torch.core.fusion`) collapses a same-agent
linear chain of captured nodes into one synthetic ``FUSED:*`` record.  Two
implementations live here:

* :func:`ewise_chain` — pure element-wise chains (EWMM/EWMD/EWADD/EWSUB
  and unary copies) in one pass: the hand-written kernel ``csrc/fused.cu``
  on CUDA tensors (the ctypes wrapper :func:`ewise_chain_hopper`, which
  replaces ``repro/kernels/fused.py::_chain_pallas``), the plain version
  :func:`ewise_chain_ref` on CPU tensors.  Intermediates stay in registers
  instead of round-tripping through device memory.
* :func:`make_composed` — a call loop over member implementations, for
  every chain: it is bit-identical to serial member execution.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from . import _cuda
from .ewise.ewise import OPS as EW_OPS
from .ewise.ref import OP_REFS

__all__ = ["ACC", "MAX_INPUTS", "MAX_STEPS", "chain_problem", "ewise_chain",
           "ewise_chain_hopper", "ewise_chain_ref", "make_composed"]

#: sentinel spec meaning "the previous step's result" in a chain step
ACC = "acc"

#: the kernel's caps: inputs it holds pointers for, steps in its table
MAX_INPUTS, MAX_STEPS = 16, 32

#: op name -> the code the C entry point takes
OPS = dict(EW_OPS, copy=4)

LAUNCHES = _cuda.counter("fused")

Steps = Tuple[Tuple[str, Any, Any], ...]


def _steps_problem(steps: Steps, n_inputs: int) -> Optional[str]:
    if not 1 <= len(steps) <= MAX_STEPS:
        return f"a chain takes 1..{MAX_STEPS} steps, got {len(steps)}"
    for s, (op, a, b) in enumerate(steps):
        if op not in OPS:
            return f"step {s}: unknown op {op!r}"
        for spec in (a,) if op == "copy" else (a, b):
            if spec == ACC:
                if s == 0:
                    return "step 0 reads the result of no step"
            elif not (isinstance(spec, int) and 0 <= spec < n_inputs):
                return f"step {s}: operand {spec!r} is not an input index"
    return None


def chain_problem(arrays: Sequence, steps: Steps) -> Optional[str]:
    """Why the chain kernel cannot take ``arrays`` and ``steps``, or None:
    1..16 contiguous operands of one shape (at least 1-D) and type, and
    1..32 valid steps."""
    if not 1 <= len(arrays) <= MAX_INPUTS:
        return f"a chain takes 1..{MAX_INPUTS} operands, got {len(arrays)}"
    why = _cuda.operand_problem(arrays)
    if why:
        return why
    shape = arrays[0].shape
    if len(shape) < 1:
        return "0-d operands go to the lower rows"
    if any(a.shape != shape for a in arrays):
        return f"chain operands differ in shape: {[tuple(a.shape) for a in arrays]}"
    return _steps_problem(steps, len(arrays))


def ewise_chain_ref(*arrays: torch.Tensor, steps: Steps) -> torch.Tensor:
    """The plain version: the steps one by one, each rounded to the input
    type as one EW launch rounds it."""
    acc = None
    for op, a, b in steps:
        x = acc if a == ACC else arrays[a]
        if op == "copy":
            acc = x
        else:
            acc = OP_REFS[op](x, acc if b == ACC else arrays[b])
    if any(acc is a for a in arrays):    # a chain that only copies
        acc = acc.clone()
    return acc


def ewise_chain_hopper(*arrays: torch.Tensor, steps: Steps) -> torch.Tensor:
    """The chain on the card in one launch, in the operands' shape and type."""
    _cuda.require_cuda(chain_problem(arrays, steps), "fused chain", arrays[0])
    out = torch.empty_like(arrays[0])
    if out.numel() == 0:
        return out
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.data_ptr() for a in arrays])
    flat = [v for op, a, b in steps
            for v in (OPS[op], -1 if a == ACC else a,
                      -1 if b == ACC or op == "copy" else b)]
    table = (ctypes.c_int * len(flat))(*flat)
    rc = _cuda.lib().halo_fused(ptrs, len(arrays), table, len(steps),
                                out.data_ptr(), out.numel(),
                                _cuda.dtype_code(out.dtype),
                                int(_cuda.aligned(out, *arrays)),
                                _cuda.stream(out.device))
    _cuda.check(rc, "fused")
    LAUNCHES.add()
    return out


def ewise_chain(*arrays: torch.Tensor, steps: Steps) -> torch.Tensor:
    """Apply a fused element-wise chain: the kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``steps`` is a static tuple of ``(op, a_spec, b_spec)`` triples: ``op``
    is one of ``mul/div/add/sub/copy``; a spec is an index into ``arrays``
    or :data:`ACC` (the previous step's result; ``copy`` ignores
    ``b_spec``).  All operands share one shape and type."""
    if all(a.device.type == "cpu" for a in arrays):
        _cuda.require(chain_problem(arrays, steps), "fused chain")
        return ewise_chain_ref(*arrays, steps=steps)
    return ewise_chain_hopper(*arrays, steps=steps)


def make_composed(fns: Sequence[Callable], argmaps: Sequence[Tuple],
                  kwargs_list: Sequence[Dict[str, Any]]) -> Callable:
    """One call loop over chain-member implementations.

    ``fns[i]`` is called with ``argmaps[i]`` resolved against the fused
    node's positional args (an integer indexes them; :data:`ACC` is the
    previous member's output) plus the member's captured ``kwargs_list[i]``.
    Each member runs as its own launch, so the loop is bit-identical to
    serial member execution; the fused node pays placement and queueing
    once instead of once per member."""
    def composed(*arrays):
        acc = None
        for fn, argmap, kw in zip(fns, argmaps, kwargs_list):
            acc = fn(*(acc if spec == ACC else arrays[spec] for spec in argmap),
                     **kw)
        return acc

    return composed
