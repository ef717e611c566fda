"""MMM on Hopper: the ctypes wrappers around ``csrc/mmm.cu`` and
``csrc/mmm_skinny.cu``, and the route between them.

Replaces ``repro/kernels/matmul/matmul.py::mmm_pallas``.  Two routes, chosen
by the row count alone (:func:`mmm_route`):

* ``tile`` (``mmm.cu``): 128x128 output tiles with a shared-memory K loop,
  for M above :data:`SKINNY_M_MAX` (prefill, the template's 4096³);
* ``skinny`` (``mmm_skinny.cu``): column strips of 16-byte loads of B with
  K split across warps and, where the strips cannot fill the card, across
  blocks (:func:`skinny_plan`), for the few rows of a decode step.

Both kernels mask ragged edges themselves, so the wrappers pad nothing.
Each route counts its own launches (``mmm`` and ``mmm_skinny``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _cuda
from ..common import cdiv, round_up

LAUNCHES = _cuda.counter("mmm")
SKINNY_LAUNCHES = _cuda.counter("mmm_skinny")

#: the largest M that takes the skinny route.  By device time on an H100
#: (chip_smoke.py phase 4, bfloat16, B cold in L2), the skinny route beat
#: the tile route at every M swept up to 256 at 2560x6912 (0.128 against
#: 0.559 ms at M = 64), but only up to 64 at the 32000-column unembed
#: (0.475 against 0.773 ms at 64; 0.943 against 0.773 at 128): it reads B
#: once per 16 rows, so its time grows with M where the tile route's does
#: not, and a wide N fills the card with tiles sooner.
SKINNY_M_MAX = 64

_MAX_GRID = 65535       # grid.y (tile: row tiles of 128; skinny: K splits)
#: skinny kernel geometry (csrc/mmm_skinny.cu): warps per block, rows per
#: row group, and the K rows a block split covers at least (4 per warp)
SKINNY_WARPS = 8
_SKINNY_ROWS = 16
_SKINNY_MIN_SEGMENT = 32
#: blocks the skinny route fills up to: two per SM on the H100's 132 (the
#: bfloat16 kernel at M ≤ 8 holds two 256-thread blocks per SM by registers)
_SKINNY_TARGET_BLOCKS = 264


def mmm_route(m: int) -> str:
    """``"skinny"`` for M ≤ :data:`SKINNY_M_MAX`, else ``"tile"``."""
    return "skinny" if m <= SKINNY_M_MAX else "tile"


def skinny_plan(m: int, n: int, k: int, element_size: int) -> Tuple[int, int, int]:
    """``(splits, kb, kw)`` of the skinny kernel: K is cut into ``splits``
    block segments of ``kb`` rows (the last one shorter), each into
    :data:`SKINNY_WARPS` warp segments of ``kw`` rows.  As many splits as
    keep strips × row groups × splits within two blocks per SM (one wave:
    a few blocks past it would take a second one), but no block segment
    under 32 rows of K."""
    strips = cdiv(n, 32 * (16 // element_size))
    want = _SKINNY_TARGET_BLOCKS // (strips * cdiv(m, _SKINNY_ROWS))
    splits = max(1, min(want, k // _SKINNY_MIN_SEGMENT, _MAX_GRID))
    kb = max(SKINNY_WARPS, round_up(cdiv(k, splits), SKINNY_WARPS))
    return max(1, cdiv(k, kb)), kb, kb // SKINNY_WARPS


def mmm_problem(a, b) -> Optional[str]:
    """Why the MMM kernels cannot take ``(a, b)``, or None."""
    why = _cuda.operand_problem((a, b))
    if why:
        return why
    if a.dim() != 2 or b.dim() != 2:
        return f"MMM takes 2-D operands, got {a.dim()}-D and {b.dim()}-D"
    if a.shape[1] != b.shape[0]:
        return f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}"
    if cdiv(a.shape[0], 128) > _MAX_GRID or max(*a.shape, b.shape[1]) >= 2**31:
        return f"shape {tuple(a.shape)} @ {tuple(b.shape)} exceeds the grid"
    return None


def _tile(a, b, out):
    m, k = a.shape
    rc = _cuda.lib().halo_mmm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              m, out.shape[1], k, _cuda.dtype_code(a.dtype),
                              _cuda.stream(a.device))
    _cuda.check(rc, "mmm")
    LAUNCHES.add()
    return out


def _skinny(a, b, out):
    m, k = a.shape
    n = out.shape[1]
    if cdiv(m, _SKINNY_ROWS) > _MAX_GRID:
        raise ValueError(f"MMM: {m} rows exceed the skinny route's grid")
    splits, kb, kw = skinny_plan(m, n, k, a.element_size())
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) \
        if splits > 1 else None
    vec = _cuda.aligned(b) and n % (16 // b.element_size()) == 0
    rc = _cuda.lib().halo_mmm_skinny(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, splits, kb, kw,
        int(vec), _cuda.dtype_code(a.dtype), _cuda.stream(a.device))
    _cuda.check(rc, "mmm_skinny")
    SKINNY_LAUNCHES.add()
    return out


def _launch(route, a, b):
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    return (_skinny if route == "skinny" else _tile)(a, b, out)


def mmm_tile_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card by the 128x128 tile kernel."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    return _launch("tile", a, b)


def mmm_skinny_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card by the skinny-M kernel, with
    a float32 workspace of ``splits`` partial products when K is split
    across blocks."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    return _launch("skinny", a, b)


def mmm_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card, in A's type, by the route
    :func:`mmm_route` picks for M."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    return _launch(mmm_route(a.shape[0]), a, b)
