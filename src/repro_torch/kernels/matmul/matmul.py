"""MMM on Hopper: the ctypes wrappers around ``csrc/mmm_skinny.cu`` and
``csrc/mmm_wgmma.cu``, and the route between them.

Replaces ``repro/kernels/matmul/matmul.py::mmm_pallas``.  Three routes,
chosen by type and row count alone (:func:`mmm_route`):

* ``skinny`` (``mmm_skinny.cu``): column strips of 16-byte loads of B with
  K split across warps and, where the strips cannot fill the card, across
  blocks (:func:`skinny_plan`), for the few rows of a decode step, up to
  :data:`SKINNY_M_MAX` rows in every type;
* ``wgmma`` (``mmm_wgmma.cu``): 128x128 or 128x256 output tiles
  (:func:`wgmma_tile_n`) on the tensor cores, TMA loads into a ring of
  shared-memory stages, for bfloat16 and float16 above SKINNY_M_MAX rows (a
  prefill's projections).  TMA needs row strides that are multiples of 16
  bytes and 16-byte-aligned bases: an operand that breaks either is first
  copied into a zero-padded, aligned workspace (:func:`wgmma_packs`);
* ``tf32x3`` (``mmm_wgmma.cu``): float32 above SKINNY_M_MAX rows (the
  template's 4096³, held to 1e-5): a split pass writes each operand's
  TF32 high and low parts into a workspace whose rows it pads to a
  multiple of 4 with zeros, reading the operands by scalar loads, and the
  same ring of TMA stages sums lo·hi + hi·lo + hi·hi on the TF32 tensor
  cores in 128x128 tiles.

So every shape and alignment has its route.  The kernels mask ragged edges
themselves (TMA zero-fills them).  A product over K = 0 is zeros and
launches nothing.  Each route counts its own launches (``mmm_skinny``,
``mmm_wgmma``, ``mmm_tf32x3``; one per call, a pack or split pass and the
product together).

The route, the skinny split count and the tensor-core tile width are the
plan's defaults; :func:`mmm_space` lists the plans a TuningDB may put in
their place (``route``, ``splits``, ``tile_n`` keyword arguments), and
:func:`check_plan` refuses any other.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import _cuda
from ..common import cdiv, round_up

SKINNY_LAUNCHES = _cuda.counter("mmm_skinny")
WGMMA_LAUNCHES = _cuda.counter("mmm_wgmma")
TF32X3_LAUNCHES = _cuda.counter("mmm_tf32x3")

#: the types the tensor-core route takes
WGMMA_DTYPES = (torch.bfloat16, torch.float16)

#: the largest M that takes the skinny route.  It reads B once per 16
#: rows, so its time grows with M where a tiled route's does not, and a
#: wide N fills the card with tiles sooner; chip_smoke.py phase 4 sweeps M
#: against the tensor-core routes in bfloat16 and float32 (PERF.md).
SKINNY_M_MAX = 64

_MAX_GRID = 65535       # grid.y (tensor cores: row tiles of 128; skinny: K splits)
#: skinny kernel geometry (csrc/mmm_skinny.cu): warps per block, rows per
#: row group, and the K rows a block split covers at least (4 per warp)
SKINNY_WARPS = 8
_SKINNY_ROWS = 16
_SKINNY_MIN_SEGMENT = 32
#: blocks the skinny route fills up to: two per SM on the H100's 132 (the
#: bfloat16 kernel at M ≤ 8 holds two 256-thread blocks per SM by registers)
_SKINNY_TARGET_BLOCKS = 264


def mmm_route(dtype: torch.dtype, m: int) -> str:
    """``"skinny"`` for M ≤ :data:`SKINNY_M_MAX` in every type; above it
    ``"wgmma"`` for bfloat16 and float16 and ``"tf32x3"`` for float32, at
    any K, N and alignment."""
    if m <= SKINNY_M_MAX:
        return "skinny"
    return "wgmma" if dtype in WGMMA_DTYPES else "tf32x3"


def wgmma_packs(k: int, n: int, a_aligned: bool, b_aligned: bool) -> Tuple[bool, bool]:
    """Which 16-bit operands the tensor-core route copies into its padded,
    aligned workspace before TMA loads them: A (M x K) when K is not a
    multiple of 8 (its row stride) or A is off the 16-byte grid, as M x
    round_up(K, 8); B (K x N) when N is not a multiple of 8 or B is off
    the grid, as K x round_up(N, 8).  B's rows past K are TMA's zero fill,
    so a K off the multiple needs only A's copy."""
    return k % 8 != 0 or not a_aligned, n % 8 != 0 or not b_aligned


def _bucket(d: int) -> int:
    """``d`` rounded up to a power of two (the TuningDB's shape bucket)."""
    return 1 if d <= 1 else 1 << (d - 1).bit_length()


def skinny_splits_space(m: int, n: int, k: int, element_size: int) -> List[int]:
    """Split counts the skinny route may take in place of
    :func:`skinny_plan`'s: the count it picks at the corner of the shape
    bucket (M, N, K rounded up to powers of two), half and double that,
    each at most K's 32-row segments at the bucket's least K and the grid.
    A function of the bucket alone, so every shape of one bucket has the
    same list."""
    bm, bn, bk = _bucket(m), _bucket(n), _bucket(k)
    k_least = bk // 2 + 1 if bk > 1 else bk
    cap = max(1, min(k_least // _SKINNY_MIN_SEGMENT, _MAX_GRID))
    s0 = skinny_plan(bm, bn, bk, element_size)[0]
    return sorted({max(1, min(s, cap)) for s in (s0 // 2, s0, 2 * s0)})


def mmm_space(a, b, **kw) -> List[Dict[str, Any]]:
    """The launch plans MMM's hopper row may be tuned over, a pure function
    of the operands' shapes and type (no SM count: it means the same on
    the CPU).  16-bit operands: at M ≤ SKINNY_M_MAX the skinny route at
    :func:`skinny_splits_space`'s split counts and the tensor-core route
    at either tile width, above it either tile width; float32: at M ≤
    SKINNY_M_MAX the skinny splits and the 3×TF32 route, above it none
    (the 3×TF32 route takes no plan).  ``{}`` — the default — is not
    listed."""
    shape_a, shape_b = tuple(getattr(a, "shape", ())), tuple(getattr(b, "shape", ()))
    dtype = getattr(a, "dtype", None)
    if len(shape_a) != 2 or len(shape_b) != 2 or shape_a[1] != shape_b[0] \
            or getattr(b, "dtype", None) != dtype \
            or dtype not in WGMMA_DTYPES + (torch.float32,):
        return []
    m, k = shape_a
    n = shape_b[1]
    if min(m, n, k) < 1:
        return []
    if m > SKINNY_M_MAX:
        return [{"tile_n": 128}, {"tile_n": 256}] if dtype in WGMMA_DTYPES else []
    out = [{"route": "skinny", "splits": s}
           for s in skinny_splits_space(m, n, k, dtype.itemsize)]
    if dtype in WGMMA_DTYPES:
        out += [{"route": "wgmma", "tile_n": 128}, {"route": "wgmma", "tile_n": 256}]
    else:
        out.append({"route": "tf32x3"})
    return out


def check_plan(a, b, plan: Dict[str, Any]) -> None:
    """Raise unless ``plan`` (the non-None of ``route``, ``splits``,
    ``tile_n``) is the default ``{}`` or one of :func:`mmm_space`'s."""
    if plan and plan not in mmm_space(a, b):
        raise ValueError(f"MMM: plan {plan} is not in the tuning space of "
                         f"{tuple(a.shape)} @ {tuple(b.shape)} {a.dtype}")


def wgmma_tile_n(m: int, n: int, sms: int) -> int:
    """Columns of the tensor-core route's output tile, 128 or 256: the width
    at which an SM computes the fewer columns, padding included, over the
    waves of tiles on ``sms`` SMs: waves × the tile's width, a wide tile
    costing 256 columns however many of them lie past N.  On a tie 256,
    which reads each A tile from shared memory once per 256 columns rather
    than twice.  By device time on an H100 (chip_smoke.py phase 4) the
    width it picks was the faster at seven of danube's eight prefill shapes
    and 4096³; at 4200x6912 @ 6912x2560 (5 waves of 128 columns against 3
    of 256) the wide tile was 6 % faster, its products running faster per
    column than the count assumes.  A TuningDB entry's ``tile_n``
    (:func:`mmm_space`) overrides this rule per shape bucket."""
    def columns(bn):
        return cdiv(cdiv(m, 128) * cdiv(n, bn), sms) * bn
    return 256 if columns(256) <= columns(128) else 128


def skinny_plan(m: int, n: int, k: int, element_size: int,
                splits: Optional[int] = None) -> Tuple[int, int, int]:
    """``(splits, kb, kw)`` of the skinny kernel: K is cut into ``splits``
    block segments of ``kb`` rows (the last one shorter), each into
    :data:`SKINNY_WARPS` warp segments of ``kw`` rows.  As many splits as
    keep strips × row groups × splits within two blocks per SM (one wave:
    a few blocks past it would take a second one), but no block segment
    under 32 rows of K.  ``splits`` — a TuningDB entry's
    (:func:`mmm_space`) — takes the rule's place; ``kb`` and ``kw`` follow
    from it the same way, and the count returned is the segments of ``kb``
    rows that cover K."""
    if splits is None:
        strips = cdiv(n, 32 * (16 // element_size))
        want = _SKINNY_TARGET_BLOCKS // (strips * cdiv(m, _SKINNY_ROWS))
        splits = max(1, min(want, k // _SKINNY_MIN_SEGMENT, _MAX_GRID))
    kb = max(SKINNY_WARPS, round_up(cdiv(k, max(1, splits)), SKINNY_WARPS))
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


def _wgmma(a, b, out, tile_n=None):
    m, k = a.shape
    n = out.shape[1]
    pack_a, pack_b = wgmma_packs(k, n, _cuda.aligned(a), _cuda.aligned(b))
    # the packed copies, A's first: M x round_up(K, 8) and K x round_up(N, 8)
    ws = torch.empty(pack_a * m * round_up(k, 8) + pack_b * k * round_up(n, 8),
                     dtype=a.dtype, device=a.device) if pack_a or pack_b else None
    rc = _cuda.lib().halo_mmm_wgmma(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    None if ws is None else ws.data_ptr(), m, n, k,
                                    tile_n or wgmma_tile_n(m, n, _cuda.sm_count(a.device)),
                                    int(pack_a), int(pack_b), _cuda.dtype_code(a.dtype),
                                    _cuda.stream(a.device))
    _cuda.check(rc, "mmm_wgmma")
    WGMMA_LAUNCHES.add()
    return out


def _tf32x3(a, b, out):
    m, k = a.shape
    n = out.shape[1]
    # [A_hi; A_lo] (2M x Kp) and [B_hi^T; B_lo^T] (2N x Kp), Kp = K rounded
    # up to 4
    ws = torch.empty(2 * (m + n) * round_up(k, 4), dtype=torch.float32, device=a.device)
    rc = _cuda.lib().halo_mmm_tf32x3(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     ws.data_ptr(), m, n, k, _cuda.stream(a.device))
    _cuda.check(rc, "mmm_tf32x3")
    TF32X3_LAUNCHES.add()
    return out


def _skinny(a, b, out, splits=None):
    m, k = a.shape
    n = out.shape[1]
    if cdiv(m, _SKINNY_ROWS) > _MAX_GRID:
        raise ValueError(f"MMM: {m} rows exceed the skinny route's grid")
    splits, kb, kw = skinny_plan(m, n, k, a.element_size(), splits)
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


def _launch(route, a, b, **options):
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if a.shape[1] == 0:
        return out.zero_()
    return {"skinny": _skinny, "wgmma": _wgmma, "tf32x3": _tf32x3}[route](a, b, out, **options)


def mmm_wgmma_hopper(a: torch.Tensor, b: torch.Tensor,
                     tile_n: Optional[int] = None) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card by the tensor-core kernel:
    bfloat16 or float16, any shape and alignment (operands TMA cannot load
    are packed first, :func:`wgmma_packs`), any M ≥ 1.  ``tile_n`` (128 or
    256) sets the tile width in place of :func:`wgmma_tile_n`'s, to time
    the two widths apart."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    if tile_n not in (None, 128, 256):
        raise ValueError(f"MMM: the tensor-core tile is 128 or 256 columns, not {tile_n}")
    if a.dtype not in WGMMA_DTYPES:
        raise ValueError(f"MMM: the tensor-core route takes bfloat16/float16 "
                         f"operands, got {a.dtype}")
    return _launch("wgmma", a, b, tile_n=tile_n)


def mmm_tf32x3_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) float32 on the card by 3×TF32 on the tensor
    cores: any shape and alignment, any M ≥ 1, with a float32 workspace of
    2·(M + N)·Kp values for the split operands (Kp = K rounded up to 4)."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    if a.dtype != torch.float32:
        raise ValueError(f"MMM: the 3xTF32 route takes float32 operands, got {a.dtype}")
    return _launch("tf32x3", a, b)


def mmm_skinny_hopper(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card by the skinny-M kernel, with
    a float32 workspace of ``splits`` partial products when K is split
    across blocks."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    return _launch("skinny", a, b)


def mmm_hopper(a: torch.Tensor, b: torch.Tensor, route: Optional[str] = None,
               splits: Optional[int] = None,
               tile_n: Optional[int] = None) -> torch.Tensor:
    """A (M,K) @ B (K,N) → (M,N) on the card, in A's type, by the route
    :func:`mmm_route` picks for the type and row count, under the plan of
    :func:`skinny_plan` or :func:`wgmma_tile_n` — or, where ``route``,
    ``splits`` or ``tile_n`` is given, under that plan, which must be one
    of :func:`mmm_space`'s (:func:`check_plan`)."""
    _cuda.require_cuda(mmm_problem(a, b), "MMM", a)
    plan = {k: v for k, v in (("route", route), ("splits", splits),
                               ("tile_n", tile_n)) if v is not None}
    check_plan(a, b, plan)
    route = plan.pop("route", None) or mmm_route(a.dtype, a.shape[0])
    return _launch(route, a, b, **plan)
