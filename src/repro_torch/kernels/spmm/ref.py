"""Plain PyTorch oracle and format helpers for SMMM, sparse × dense matmul
(port of ``repro.kernels.spmm.ref``).

The sparse operand is in blocked ELL form (a fixed number of nonzero blocks
per block row, −1 padded):

  values  (R, S, bm, bk)   dense nonzero blocks
  indices (R, S) int32     block-column ids, −1 = padding

Pad slots are skipped wherever the format is read, whatever their values
hold.
"""
from __future__ import annotations

import torch

from ..common import round_up
from ..matmul.ref import tf32_split
from .spmm import ROW_TILE, STAGE_DEPTH, smmm_planes, smmm_workspace_shapes


def dense_to_bell(a: torch.Tensor, bm: int, bk: int):
    """Blocked-ELL ``(values, indices)`` of a dense (M, K) matrix: each block
    row's nonzero blocks in ascending column order, S = the most any row
    has (at least 1), pad slots zero-filled with index −1."""
    m, k = a.shape
    if m % bm or k % bk:
        raise ValueError(f"{tuple(a.shape)} is not a whole number of "
                         f"{bm}x{bk} blocks")
    nrows, ncols = m // bm, k // bk
    blocks = a.reshape(nrows, bm, ncols, bk).permute(0, 2, 1, 3)
    nz = (blocks != 0).any(dim=3).any(dim=2)                  # (R, C)
    snnz = max(1, int(nz.sum(dim=1).max()))
    values = torch.zeros((nrows, snnz, bm, bk), dtype=a.dtype, device=a.device)
    indices = torch.full((nrows, snnz), -1, dtype=torch.int32, device=a.device)
    rows, cols = nz.nonzero(as_tuple=True)                     # row-major order
    slots = (nz.cumsum(dim=1) - 1)[rows, cols]
    values[rows, slots] = blocks[rows, cols]
    indices[rows, slots] = cols.to(torch.int32)
    return values, indices


def bell_to_dense(values: torch.Tensor, indices: torch.Tensor, k: int):
    """The dense (R·bm, k) matrix of blocked-ELL parts; pad slots add
    nothing, repeated indices add up."""
    nrows, snnz, bm, bk = values.shape
    out = torch.zeros((nrows, k // bk, bm, bk), dtype=values.dtype,
                      device=values.device)
    rows, slots = (indices >= 0).nonzero(as_tuple=True)
    cols = indices[rows, slots].long()
    out.index_put_((rows, cols), values[rows, slots], accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(nrows * bm, k)


def random_block_sparse(gen: torch.Generator, m: int, k: int, bm: int, bk: int,
                        density: float = 0.25, dtype=torch.float32):
    """Random block-sparse dense (m, k) matrix on ``gen``'s device: each
    bm×bk block is kept with probability ``density`` (block column 0 always,
    so no block row is empty), its entries standard normal."""
    nrows, ncols = m // bm, k // bk
    dev = gen.device
    mask = torch.rand((nrows, ncols), generator=gen, device=dev) < density
    mask[:, 0] = True
    vals = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    full = mask.repeat_interleave(bm, dim=0).repeat_interleave(bk, dim=1)
    return vals * full.to(dtype)


def smmm_ref(a_dense, b):
    """Dense oracle: A @ B of the reconstructed sparse operand, float32
    accumulation, in b's type."""
    return (a_dense.float() @ b.float()).to(b.dtype)


def _slot_products(values, indices, b, product):
    """Σ over the S slots of ``product(value blocks, gathered B blocks)`` in
    float32, pad slots masked out: (R·bm, N) in b's type.  One slot at a
    time, so no (R, S, bk, N) gather is ever built."""
    nrows, snnz, bm, bk = values.shape
    n = b.shape[1]
    b3 = b.reshape(-1, bk, n)
    acc = torch.zeros((nrows, bm, n), dtype=torch.float32, device=b.device)
    for s in range(snnz):
        idx = indices[:, s].long()
        keep = idx >= 0
        acc = product(acc, values[:, s], b3[idx.clamp(min=0)], keep)
    return acc.reshape(nrows * bm, n).to(b.dtype)


def smmm_bell_ref(values, indices, b):
    """Blocked-ELL A @ B (the fail-safe): per slot, the gathered B blocks
    times the value blocks in float32, added where the slot is not a pad."""
    def product(acc, v, g, keep):
        return acc + torch.where(keep[:, None, None], v.float() @ g.float(), 0.0)
    return _slot_products(values, indices, b, product)


def smmm_aten(values, indices, b):
    """The library row, the mirror of the reference's ``smmm_xla``: per
    slot one ``torch.baddbmm`` of the masked value blocks by the gathered B
    blocks into a float32 accumulator."""
    def product(acc, v, g, keep):
        v = v.float() * keep[:, None, None].float()
        return torch.baddbmm(acc, v, g.float())
    return _slot_products(values, indices, b, product)


def smmm_tf32x3_workspace(values, indices, b):
    """The split pass's workspace as ``csrc/spmm.cu`` writes it, ``(ws_v,
    ws_b)`` of :func:`~.spmm.smmm_workspace_shapes`, float32.  ``ws_v``
    holds the value planes, [V_hi; V_lo] of :func:`tf32_split` for float32
    and the values themselves for the 16-bit types (exact in TF32): slot
    (r, s) at rows (r·S + s)·bmp of each plane, zeros past bm and bk.  A
    pad slot's rows hold NaN, where the kernel leaves its workspace
    unwritten.  ``ws_b`` holds B's transposed planes, block column c's bk
    rows of B at columns c·bkp onward and zeros up to (c + 1)·bkp."""
    nrows, snnz, bm, bk = values.shape
    k, n = b.shape
    planes = smmm_planes(b.dtype)
    (_, bkp), (_, kq) = smmm_workspace_shapes(nrows, snnz, bm, bk, k, n, planes)
    bmp = round_up(bm, ROW_TILE)
    blocks = values.new_zeros((nrows, snnz, bmp, bkp), dtype=torch.float32)
    blocks[:, :, :bm, :bk] = values.float()
    cols = b.new_zeros((n, k // bk, bkp), dtype=torch.float32)
    cols[:, :, :bk] = b.float().t().reshape(n, k // bk, bk)

    def split(x):
        return list(tf32_split(x)) if planes == 2 else [x]

    v_planes = split(blocks)
    for p in v_planes:
        p[indices < 0] = float("nan")
    return (torch.cat([p.reshape(-1, bkp) for p in v_planes]),
            torch.cat(split(cols.reshape(n, kq))))


def smmm_tf32x3_product(ws_v, ws_b, indices, bm, planes):
    """The product kernel's sums over a :func:`smmm_tf32x3_workspace` of
    ``planes`` planes: each block row walks its slots in order, skips pad
    slots, and adds each 32-deep stage's V_lo·B_hi + V_hi·B_lo + V_hi·B_hi
    (one plane: V·B), float32 products over the stage, to its float32
    sums.  The kernel sums a stage's terms per K step of 8, in another
    order.  (R·bm, N) float32."""
    nrows, snnz = indices.shape
    bkp, kq = ws_v.shape[1], ws_b.shape[1]
    bmp, n = ws_v.shape[0] // (planes * nrows * snnz), ws_b.shape[0] // planes
    v_planes = [p.reshape(nrows, snnz, bmp, bkp) for p in ws_v.chunk(planes)]
    b_planes = ws_b.chunk(planes)
    depth = torch.arange(STAGE_DEPTH, device=ws_b.device)
    acc = ws_v.new_zeros((nrows, bmp, n))
    for s in range(snnz):
        idx = indices[:, s].long()
        keep = idx >= 0
        for j in range(0, bkp, STAGE_DEPTH):
            v = [p[:, s, :, j:j + STAGE_DEPTH] for p in v_planes]
            cols = idx.clamp(min=0)[:, None] * bkp + j + depth       # (R, 32)
            g = [p[:, cols].permute(1, 2, 0) for p in b_planes]     # (R, 32, N)
            part = v[1] @ g[0] + v[0] @ g[1] + v[0] @ g[0] if planes == 2 else v[0] @ g[0]
            acc = torch.where(keep[:, None, None], acc + part, acc)
    return acc[:, :bm].reshape(nrows * bm, n)


def smmm_tf32x3_ref(values, indices, b):
    """The tensor-core kernel's plain model: :func:`smmm_tf32x3_product` of
    the padded :func:`smmm_tf32x3_workspace`, in b's type."""
    ws_v, ws_b = smmm_tf32x3_workspace(values, indices, b)
    return smmm_tf32x3_product(ws_v, ws_b, indices, values.shape[2],
                               smmm_planes(b.dtype)).to(b.dtype)
