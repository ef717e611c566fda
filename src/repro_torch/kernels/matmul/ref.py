"""Plain PyTorch oracle for MMM (port of ``repro.kernels.matmul.ref``)."""
import torch

from .matmul import SKINNY_WARPS, skinny_plan


def mmm_ref(a, b):
    """C = A @ B with float32 accumulation, in A's type (the fail-safe)."""
    return (a.float() @ b.float()).to(a.dtype)


def mmm_splitk_ref(a, b):
    """The skinny kernel's plain version: C = A @ B summed over K in the
    kernel's own segments (:func:`~.matmul.skinny_plan`).  Each warp
    segment is one float32 partial product; a block sums its warps'
    partials in warp order, the splits are summed in split order, all in
    float32, and the result is rounded once to A's type."""
    m, k = a.shape
    n = b.shape[1]
    splits, kb, kw = skinny_plan(m, n, k, a.element_size())
    af, bf = a.float(), b.float()
    total = None
    for s in range(splits):
        block = None
        for w in range(SKINNY_WARPS):
            lo = s * kb + w * kw
            hi = min(k, s * kb + kb, lo + kw)
            part = af[:, lo:hi] @ bf[lo:hi] if lo < hi else af.new_zeros((m, n))
            block = part if block is None else block + part
        total = block if total is None else total + block
    return total.to(a.dtype)


def mmm_aten(a, b):
    """The library row: one ``torch.matmul`` in the operands' type (cuBLAS
    on the card), as the reference's XLA row emits its dot in the operand
    type."""
    return torch.matmul(a, b)
