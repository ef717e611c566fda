"""SORT and HIST on Hopper: the ctypes wrappers around ``csrc/sort.cu``,
``csrc/sort_radix.cu`` and ``csrc/hist.cu``, and SORT's route.

Replace ``repro/kernels/sorthist/sorthist.py::sort_pallas`` and
``::hist_pallas``.

SORT orders 32-bit keys that order every float (NaN above +inf), by one of
two routes chosen by the row length alone (:func:`sort_route`):

* ``tile`` (``sort.cu``), rows of at most :data:`SORT_TILE` places after
  rounding up to a power of two: a bitonic network per row whose keys stay
  in registers under :func:`sort_tile_plan` (E keys a thread, a row over
  the lanes of one warp or of several), one launch, with a sentinel key
  above every NaN for the places past the row's length;
* ``radix`` (``sort_radix.cu``), longer rows: a least-significant-digit
  radix sort of 8-bit digits that skips the digits constant over a row,
  through two key buffers and count tables the wrapper allocates
  (:func:`radix_scratch`).

Each route counts its own launches (``sort`` and ``sort_radix``).

HIST counts integers in per-warp shared-memory sub-histograms, adds each
block's counts to 64-bit global counts with one atomic per bin, and writes
them as float32: the result does not depend on the atomics' order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import _cuda
from ..common import cdiv, next_pow2
from .ref import RADIX_PASSES

SORT_LAUNCHES = _cuda.counter("sort")
RADIX_LAUNCHES = _cuda.counter("sort_radix")
HIST_LAUNCHES = _cuda.counter("hist")

#: places of the longest row the tile kernel takes (csrc/sort.cu's kTile);
#: it refuses longer rows
SORT_TILE = 8192
#: keys a thread holds in registers, at most (csrc/sort.cu's kMaxKeys), and
#: the threads a block of short rows takes at most (on an H100, 128-thread
#: blocks ran rows of 256 and 1024 places faster than 256-thread ones, and
#: 32 keys a thread, which spill, no faster than 16 at any length)
SORT_KEYS = 16
SORT_BLOCK = 128
#: keys per block of the radix kernels (csrc/sort_radix.cu's kTileKeys)
#: and the values of an 8-bit digit
RADIX_TILE = 4096
RADIX = 256


def sort_route(n: int) -> str:
    """``"tile"`` when a row of n places fits one shared-memory tile
    (``next_pow2(n) <= SORT_TILE``), else ``"radix"``.

    The tile's capacity is also the measured crossover: on an H100 SXM at
    2^24 float32 keys, the register-resident tile route is 13x (n = 8192,
    and 4097 padded to 8192) to 1000x (n = 256) faster than the radix route
    at every row length it takes; ``chip_smoke.py`` phase 4 sweeps both
    routes."""
    return "tile" if next_pow2(n) <= SORT_TILE else "radix"


class SortTilePlan(NamedTuple):
    """How the tile kernel holds the rows: ``keys_per_thread`` (E) keys in
    each thread's registers, ``threads_per_row`` (T) threads a row, place
    t·E + s of a row in slot s of thread t; ``rows_per_block`` (R) rows to a
    block of T·R threads; ``blocks`` blocks."""
    keys_per_thread: int
    threads_per_row: int
    rows_per_block: int
    blocks: int

    @property
    def places(self) -> int:
        """The row's places, next_pow2(n): E·T."""
        return self.keys_per_thread * self.threads_per_row

    @property
    def threads(self) -> int:
        return self.threads_per_row * self.rows_per_block

    @property
    def shared_bytes(self) -> int:
        """The most shared memory a block takes (csrc/sort.cu tile_smem): two
        buffers of R rows of keys for the steps whose partner lies in
        another warp (none when a row fits one warp), or R rows of
        places + places / 32 words to stage the stores of rows off the
        16-byte grid, whichever is larger."""
        r, p = self.rows_per_block, self.places
        return max(0 if self.threads_per_row <= 32 else 2 * 4 * r * p, 4 * r * (p + p // 32))


def _tile_rows(places: int) -> Tuple[int, int, int, int]:
    """``(E, T, r_min, r_max)`` of the tile kernel for rows of ``places``
    (a power of two): E keys a thread, T threads a row, and the rows a
    block may hold, at least a warp's worth, at most SORT_BLOCK / T."""
    e = min(places, SORT_KEYS)
    t = places // e
    r_min = max(1, 32 // t)
    return e, t, r_min, max(r_min, SORT_BLOCK // t)


def sort_space(x, **kw) -> List[Dict[str, Any]]:
    """The launch plans SORT's hopper row may be tuned over, on the tile
    route only (rows of at most :data:`SORT_TILE` places; the radix route
    takes no plan): R rows a block, each power of two from the least to
    the most :func:`sort_tile_plan` would choose.  A function of
    next_pow2(n) alone."""
    shape = tuple(getattr(x, "shape", ()))
    if not shape or shape[-1] < 1 or next_pow2(shape[-1]) > SORT_TILE:
        return []
    _, _, r_min, r_max = _tile_rows(next_pow2(shape[-1]))
    out, r = [], r_min
    while r <= r_max:
        out.append({"rows_per_block": r})
        r *= 2
    return out


def check_plan(x, rows_per_block: Optional[int]) -> None:
    """Raise unless ``rows_per_block`` is None or one of :func:`sort_space`'s."""
    if rows_per_block is not None and \
            {"rows_per_block": rows_per_block} not in sort_space(x):
        raise ValueError(f"SORT: {rows_per_block} rows a block is not in the "
                         f"tuning space of rows of {x.shape[-1]} places")


def sort_tile_plan(rows: int, n: int, sms: int,
                   rows_per_block: Optional[int] = None) -> SortTilePlan:
    """The tile kernel's launch plan for ``rows`` rows of ``n`` places (n ≤
    :data:`SORT_TILE`), a pure function of rows, n and the SM count.  A
    thread holds E = min(next_pow2(n), :data:`SORT_KEYS`) keys, so a row of
    4096 spans 256 threads (8 warps) and a row of at most 512 one warp or
    part of one.  A block holds R rows: at least a warp's worth (32 / T),
    at most :data:`SORT_BLOCK` / T (one row where T is larger), and below
    that as few as spread the rows over ``sms`` blocks (R a power of
    two) — or ``rows_per_block`` where a tuned plan gives it
    (:func:`sort_space`).  ``blocks`` follows from R."""
    if not 1 <= n <= SORT_TILE:
        raise ValueError(f"SORT: the tile route takes rows of 1 to {SORT_TILE} "
                         f"places, got {n}")
    e, t, r_min, r_max = _tile_rows(next_pow2(n))
    r = rows_per_block or min(max(next_pow2(cdiv(rows, sms)), r_min), r_max)
    return SortTilePlan(e, t, r, max(1, cdiv(rows, r)))


def radix_scratch(rows: int, n: int) -> Tuple[int, int]:
    """``(keys_len, tables_len)``, in uint32 elements, of the radix route's
    scratch: two ping-pong key buffers of rows x n, and per row the histogram
    of each digit, the pass plan and the digit counts of every tile."""
    tiles = cdiv(n, RADIX_TILE)
    return (2 * rows * n,
            rows * (RADIX_PASSES * RADIX + 1) + RADIX_PASSES * rows * RADIX * tiles)


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


def _sort_tile(x, out, rows, n, rows_per_block=None):
    plan = sort_tile_plan(rows, n, _cuda.sm_count(x.device), rows_per_block)
    vec = _cuda.aligned(x, out) and (n * x.element_size()) % 16 == 0
    rc = _cuda.lib().halo_sort(x.data_ptr(), out.data_ptr(), rows, n, *plan,
                               _cuda.dtype_code(x.dtype), int(vec),
                               _cuda.stream(x.device))
    _cuda.check(rc, "sort")
    SORT_LAUNCHES.add()


def _sort_radix(x, out, rows, n):
    keys_len, tables_len = radix_scratch(rows, n)
    keys = torch.empty(keys_len, dtype=torch.int32, device=x.device)
    tables = torch.empty(tables_len, dtype=torch.int32, device=x.device)
    rc = _cuda.lib().halo_sort_radix(x.data_ptr(), out.data_ptr(), keys.data_ptr(),
                                     keys.numel(), tables.data_ptr(), tables.numel(),
                                     rows, n, _cuda.dtype_code(x.dtype),
                                     _cuda.stream(x.device))
    _cuda.check(rc, "sort_radix")
    RADIX_LAUNCHES.add()


def _sort(route, x, rows_per_block=None):
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n = x.shape[-1]
    if route == "radix":
        _sort_radix(x, out, x.numel() // n, n)
    else:
        _sort_tile(x, out, x.numel() // n, n, rows_per_block)
    return out


def sort_tile_hopper(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of the last axis on the card by the register-resident
    bitonic kernel under :func:`sort_tile_plan` (rows of at most
    :data:`SORT_TILE` places)."""
    _cuda.require_cuda(sort_problem(x), "SORT", x)
    if sort_route(x.shape[-1]) != "tile":
        raise ValueError(f"SORT: the tile route takes rows of at most {SORT_TILE} "
                         f"places, got {x.shape[-1]}")
    return _sort("tile", x)


def sort_radix_hopper(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of the last axis on the card by the radix kernels,
    with key buffers and count tables of :func:`radix_scratch` (any row
    length)."""
    _cuda.require_cuda(sort_problem(x), "SORT", x)
    return _sort("radix", x)


def sort_hopper(x: torch.Tensor, rows_per_block: Optional[int] = None) -> torch.Tensor:
    """Ascending sort of the last axis on the card, in x's type, NaN last,
    by the route :func:`sort_route` picks for the row length (the tile
    route at ``rows_per_block``, a tuned plan's R, where given)."""
    _cuda.require_cuda(sort_problem(x), "SORT", x)
    check_plan(x, rows_per_block)
    return _sort(sort_route(x.shape[-1]), x, rows_per_block)


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
