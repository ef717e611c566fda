"""SMMM on Hopper: the ctypes wrapper around ``csrc/spmm.cu``.

Replaces ``repro/kernels/spmm/spmm.py::smmm_pallas``.  3×TF32 on the
tensor cores over the kept blocks: a split pass writes each kept value
block's TF32 high and low parts, and B's transposed, into a workspace
padded to whole 64-row tiles and 32-deep stages (:func:`smmm_workspace_shapes`),
and the product kernel sums lo·hi + hi·lo + hi·hi over each block row's
kept slots, in slot order, skipping pad slots (negative indices).  The
16-bit types are exact in TF32: one plane and one product.  bm, bk and N
are any values the format allows.

Indices are not checked against K on the host (that would cost a device
sync per request): an index outside [−1, K/bk) gives an undefined result,
as in the reference, but the kernel never reads outside ``b`` or the
workspace.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _cuda
from ..common import cdiv, round_up

LAUNCHES = _cuda.counter("spmm")

#: the product kernel's tile: 64 rows of a block row, 256 columns; each
#: stage is 32 deep (csrc/spmm.cu)
ROW_TILE, COL_TILE, STAGE_DEPTH = 64, 256, 32
_MAX_GRID_Y = 65535


def smmm_planes(dtype: torch.dtype) -> int:
    """TF32 planes of an operand in the workspace: hi and lo for float32,
    hi alone for bfloat16 and float16, which TF32 holds exactly."""
    return 2 if dtype == torch.float32 else 1


def smmm_workspace_shapes(nrows: int, snnz: int, bm: int, bk: int, k: int, n: int,
                          planes: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The split pass's two float32 arrays, (rows, columns) each: the value
    planes, ``planes`` × R·S blocks of bmp rows (bm rounded up to
    ROW_TILE) by bkp columns (bk rounded up to STAGE_DEPTH), and B's
    transposed planes, ``planes`` × N rows of K/bk·bkp columns, block column
    c at columns c·bkp onward."""
    bmp, bkp = round_up(bm, ROW_TILE), round_up(bk, STAGE_DEPTH)
    return (planes * nrows * snnz * bmp, bkp), (planes * n, k // bk * bkp)


def smmm_problem(values, indices, b) -> Optional[str]:
    """Why the SMMM kernel cannot take ``(values, indices, b)``, or None."""
    why = _cuda.operand_problem((values, b)) or _cuda.index_problem(indices, b)
    if why:
        return why
    if values.dim() != 4 or indices.dim() != 2 or b.dim() != 2:
        return (f"SMMM takes values (R,S,bm,bk), indices (R,S) and b (K,N), "
                f"got {values.dim()}-D, {indices.dim()}-D and {b.dim()}-D")
    nrows, snnz, bm, bk = values.shape
    if tuple(indices.shape) != (nrows, snnz):
        return (f"indices {tuple(indices.shape)} do not match values "
                f"{tuple(values.shape)}")
    k, n = b.shape
    if bm < 1 or bk < 1 or k % bk:
        return f"b has {k} rows, not a whole number of bk={bk} blocks"
    # TMA's coordinates and the grids are 32-bit: both planes' rows, B^T's
    # columns, a block's padded values, the split pass's blocks
    (v_rows, bkp), (_, kq) = smmm_workspace_shapes(nrows, snnz, bm, bk, k, n, 2)
    split_blocks = nrows * snnz + kq // 32 * cdiv(n, 32)
    if max(nrows * bm, k, n, v_rows, kq, round_up(bm, ROW_TILE) * bkp,
           split_blocks) >= 2**31 \
            or cdiv(n, COL_TILE) > _MAX_GRID_Y:
        return f"values {tuple(values.shape)} @ b {tuple(b.shape)} exceeds the grid"
    return None


def smmm_hopper(values: torch.Tensor, indices: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL A @ B on the card: (R·bm, N) in b's type, with a float32
    workspace of the split planes (:func:`smmm_workspace_shapes`).  No
    slot or K = 0 gives zeros and launches nothing."""
    _cuda.require_cuda(smmm_problem(values, indices, b), "SMMM", b)
    nrows, snnz, bm, bk = values.shape
    k, n = b.shape
    out = torch.empty((nrows * bm, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    if snnz == 0 or k == 0:
        return out.zero_()
    (v_rows, bkp), (b_rows, kq) = smmm_workspace_shapes(nrows, snnz, bm, bk, k, n,
                                                        smmm_planes(b.dtype))
    ws = torch.empty(v_rows * bkp + b_rows * kq, dtype=torch.float32, device=b.device)
    rc = _cuda.lib().halo_smmm(values.data_ptr(), indices.data_ptr(),
                               b.data_ptr(), out.data_ptr(), ws.data_ptr(), nrows,
                               snnz, bm, bk, k, n, _cuda.dtype_code(b.dtype),
                               _cuda.stream(b.device))
    _cuda.check(rc, "spmm")
    LAUNCHES.add()
    return out
