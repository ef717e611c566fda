"""SMMM on Hopper: the ctypes wrapper around ``csrc/spmm.cu``.

Replaces ``repro/kernels/spmm/spmm.py::smmm_pallas``.  One block per (64
rows of a block row, 256 columns of B) loops over the row's slots, reads
each index itself and skips pad slots (−1) without loading anything for
them.  bm, bk and N are runtime values with masked edges.

Indices are not checked against K on the host (that would cost a device
sync per request): an index outside [−1, K/bk) gives an undefined result,
as in the reference, but the kernel never reads outside ``b``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("spmm")

_ROW_TILE, _COL_TILE = 64, 256     # the kernel's block tile
_MAX_GRID_Y = 65535


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
    if max(nrows * bm, k, n) >= 2**31 \
            or nrows * cdiv(bm, _ROW_TILE) >= 2**31 \
            or cdiv(n, _COL_TILE) > _MAX_GRID_Y:
        return f"values {tuple(values.shape)} @ b {tuple(b.shape)} exceeds the grid"
    return None


def smmm_hopper(values: torch.Tensor, indices: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL A @ B on the card: (R·bm, N) in b's type."""
    _cuda.require_cuda(smmm_problem(values, indices, b), "SMMM", b)
    nrows, snnz, bm, bk = values.shape
    k, n = b.shape
    out = torch.empty((nrows * bm, n), dtype=b.dtype, device=b.device)
    if out.numel() == 0:
        return out
    rc = _cuda.lib().halo_smmm(values.data_ptr(), indices.data_ptr(),
                               b.data_ptr(), out.data_ptr(), nrows, snnz, bm,
                               bk, k, n, _cuda.dtype_code(b.dtype),
                               _cuda.stream(b.device))
    _cuda.check(rc, "spmm")
    LAUNCHES.add()
    return out
