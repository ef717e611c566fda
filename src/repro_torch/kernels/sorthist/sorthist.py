"""SORT and HIST on Hopper: the ctypes wrappers around ``csrc/sort.cu`` and
``csrc/hist.cu``.

Replace ``repro/kernels/sorthist/sorthist.py::sort_pallas`` and
``::hist_pallas``.

SORT is a bitonic network over each row on 32-bit keys that order every
float (NaN above +inf) and a sentinel key above every NaN for the places
between the row's length and the next power of two, so NaN sorts last and
no padding is copied.  Rows that fit one shared-memory tile sort in one
launch; longer rows sort tile by tile, then merge with global-memory
compare-exchange passes and shared-memory passes over the short strides,
through an int32 key buffer the wrapper allocates.

HIST counts integers in per-warp shared-memory sub-histograms, adds each
block's counts to 64-bit global counts with one atomic per bin, and writes
them as float32: the result does not depend on the atomics' order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _cuda
from ..common import next_pow2

SORT_LAUNCHES = _cuda.counter("sort")
HIST_LAUNCHES = _cuda.counter("hist")

#: keys one block sorts in shared memory (32 KB), csrc/sort.cu's kTile;
#: the kernel refuses a key buffer shorter than its merge path needs
SORT_TILE = 8192


def sort_problem(x) -> Optional[str]:
    """Why the SORT kernel cannot take ``x``, or None."""
    why = _cuda.operand_problem((x,))
    if why:
        return why
    if x.dim() == 0:
        return "SORT takes an input of at least one dimension, got a 0-d tensor"
    return None


def hist_problem(x, bins, lo, hi) -> Optional[str]:
    """Why the HIST kernel cannot take ``x`` with these bins, or None."""
    why = _cuda.operand_problem((x,))
    if why:
        return why
    if not isinstance(bins, int) or not 1 <= bins < 2**31:
        return f"HIST needs an integer bin count >= 1, got {bins!r}"
    if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
        return f"HIST needs finite lo < hi, got lo={lo}, hi={hi}"
    return None


def sort_hopper(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of the last axis on the card, in x's type, NaN last."""
    _cuda.require_cuda(sort_problem(x), "SORT", x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n = x.shape[-1]
    rows = x.numel() // n
    npow2 = next_pow2(n)
    # rows longer than one tile merge through a key buffer of npow2 per row
    keys = torch.empty((rows, npow2) if npow2 > SORT_TILE else (0,),
                       dtype=torch.int32, device=x.device)
    rc = _cuda.lib().halo_sort(x.data_ptr(), out.data_ptr(), keys.data_ptr(),
                               keys.numel(), rows, n, npow2,
                               _cuda.dtype_code(x.dtype), _cuda.stream(x.device))
    _cuda.check(rc, "sort")
    SORT_LAUNCHES.add()
    return out


def hist_hopper(x: torch.Tensor, *, bins: int = 64, lo: float = 0.0,
                hi: float = 1.0) -> torch.Tensor:
    """float32 bin counts (bins,) of the flattened ``x`` on the card.  The
    C call takes ``lo``, ``hi`` and ``(hi - lo) / bins`` as C floats, which
    rounds each once to float32, as the contract says."""
    _cuda.require_cuda(hist_problem(x, bins, lo, hi), "HIST", x)
    counts = torch.empty((bins,), dtype=torch.int64, device=x.device)
    out = torch.empty((bins,), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().halo_hist(x.data_ptr(), counts.data_ptr(), out.data_ptr(),
                               x.numel(), bins, lo, hi, (hi - lo) / bins,
                               _cuda.dtype_code(x.dtype), _cuda.stream(x.device))
    _cuda.check(rc, "hist")
    HIST_LAUNCHES.add()
    return out
