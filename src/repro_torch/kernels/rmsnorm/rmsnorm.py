"""RMSNORM on Hopper: the ctypes wrapper around ``csrc/rmsnorm.cu`` and its
launch plan.

Replaces ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas``.  Rows that
are 16-byte aligned and fill whole 16-byte vectors take the rows kernel
under :func:`rmsnorm_plan`: W warps share a row, each lane holding V
vectors of x and of gamma in registers, V sized to the row; other rows
take one block per row.  float32 inside; nothing is padded, so the wrapper
passes the rows as they are.  A TuningDB entry may set W
(:func:`rmsnorm_space`); the sum order follows W, so the bits do too.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("rmsnorm")

#: the rows kernel's block: 8 warps of 32 lanes (csrc/rmsnorm.cu kThreads)
WARPS = 8
#: warps a row may take, and the vectors a lane may hold (kMaxVecs)
ROW_WARPS = (1, 2, 4, 8)
MAX_VECS = 16
#: the plan adds warps to a row until a lane holds at most VEC_BUDGET
#: vectors and the blocks number at least one per SM.  On an H100 (ptxas
#: counts, chip_smoke.py phase 1) a bfloat16 lane at 3 vectors holds 64
#: registers, so 4 blocks of 256 fit an SM; at 5 it holds 117 (2 blocks),
#: at 10 201 (1 block)
VEC_BUDGET = 4


class RmsnormPlan(NamedTuple):
    """How the kernel covers the rows: ``warps_per_row`` (W) warps to a
    row, 8 / W rows to a block, ``vecs_per_lane`` 16-byte vectors a lane,
    ``blocks`` blocks; W = 0 is the block kernel, one block per row."""
    warps_per_row: int
    vecs_per_lane: int
    blocks: int

    @property
    def rows_per_block(self) -> int:
        return WARPS // self.warps_per_row if self.warps_per_row else 1


def rmsnorm_plan(rows: int, d: int, element_size: int, sms: int,
                 aligned: bool = True,
                 warps_per_row: Optional[int] = None) -> RmsnormPlan:
    """The launch plan for ``rows`` rows of ``d`` elements.  Rows that are
    not 16-byte aligned (``aligned`` False or d·element_size off a multiple
    of 16) or longer than 8 warps of 16 vectors a lane take the block
    kernel.  Else W is the least of 1, 2, 4, 8 at which a lane holds at
    most VEC_BUDGET vectors and the blocks reach ``sms``, or at which 32·W
    lanes hold the row a vector each (more warps would idle) — or
    ``warps_per_row`` where a tuned plan gives it (:func:`rmsnorm_space`).
    ``vecs_per_lane`` and ``blocks`` follow from W.  A tuned W does not
    move rows off the 16-byte grid off the block kernel."""
    nvec, rem = divmod(d * element_size, 16)
    if not aligned or rem or nvec > 32 * WARPS * MAX_VECS:
        return RmsnormPlan(0, 0, rows)
    w = warps_per_row or next(w for w in ROW_WARPS if w == WARPS or 32 * w >= nvec or (
        cdiv(nvec, 32 * w) <= VEC_BUDGET and cdiv(rows, WARPS // w) >= sms))
    return RmsnormPlan(w, cdiv(nvec, 32 * w), cdiv(rows, WARPS // w))


def rmsnorm_space(x, gamma=None, **kw) -> List[Dict[str, Any]]:
    """The launch plans RMSNORM's hopper row may be tuned over: W in
    :data:`ROW_WARPS` warps a row at which a lane holds at most
    :data:`MAX_VECS` vectors, for rows that fill whole 16-byte vectors (the
    rows kernel's); a function of d and the type alone."""
    shape, dtype = tuple(getattr(x, "shape", ())), getattr(x, "dtype", None)
    if not shape or not isinstance(dtype, torch.dtype) or shape[-1] < 1:
        return []
    nvec, rem = divmod(shape[-1] * dtype.itemsize, 16)
    if rem or nvec > 32 * WARPS * MAX_VECS:
        return []
    return [{"warps_per_row": w} for w in ROW_WARPS if cdiv(nvec, 32 * w) <= MAX_VECS]


def check_plan(x, warps_per_row: Optional[int]) -> None:
    """Raise unless ``warps_per_row`` is None or one of
    :func:`rmsnorm_space`'s."""
    if warps_per_row is not None and \
            {"warps_per_row": warps_per_row} not in rmsnorm_space(x):
        raise ValueError(f"RMSNORM: {warps_per_row} warps a row is not in the "
                         f"tuning space of rows of {x.shape[-1]} {x.dtype}")


def rmsnorm_problem(x, gamma) -> Optional[str]:
    """Why the RMSNORM kernel cannot take ``(x, gamma)``, or None."""
    why = _cuda.operand_problem((x, gamma))
    if why:
        return why
    if x.dim() < 1 or gamma.dim() != 1:
        return (f"RMSNORM takes x (..., D) and gamma (D,), got {x.dim()}-D "
                f"and {gamma.dim()}-D")
    if x.shape[-1] != gamma.shape[0]:
        return f"gamma {tuple(gamma.shape)} does not match x {tuple(x.shape)}"
    if x.shape[-1] == 0 or x.numel() // x.shape[-1] >= 2**31 \
            or x.shape[-1] >= 2**31:
        return f"shape {tuple(x.shape)} is empty or exceeds the grid"
    return None


def rmsnorm_hopper(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
                   warps_per_row: Optional[int] = None) -> torch.Tensor:
    """RMSNorm of x over its last dim on the card, in x's type, under
    :func:`rmsnorm_plan` (at ``warps_per_row``, a tuned plan's W, where
    given)."""
    _cuda.require_cuda(rmsnorm_problem(x, gamma), "RMSNORM", x)
    check_plan(x, warps_per_row)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    vec = _cuda.aligned(x, gamma, out)
    plan = rmsnorm_plan(rows, d, x.element_size(), _cuda.sm_count(x.device), vec,
                        warps_per_row)
    rc = _cuda.lib().halo_rmsnorm(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
                                  float(eps), _cuda.dtype_code(x.dtype),
                                  int(vec and (d * x.element_size()) % 16 == 0), *plan,
                                  _cuda.stream(x.device))
    _cuda.check(rc, "rmsnorm")
    LAUNCHES.add()
    return out
