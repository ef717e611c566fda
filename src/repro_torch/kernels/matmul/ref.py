"""Plain PyTorch oracle for MMM (port of ``repro.kernels.matmul.ref``)."""
import torch

from ..common import round_up
from .matmul import SKINNY_WARPS, skinny_plan


def mmm_ref(a, b):
    """C = A @ B with float32 accumulation, in A's type (the fail-safe)."""
    return (a.float() @ b.float()).to(a.dtype)


#: half an output ulp of a 16-bit type relative to |r|: 2^-8 for bfloat16 (8
#: significant bits), 2^-11 for float16 (11).  Rounding to nearest moves r
#: by at most half an ulp of r, which is at most this fraction of |r|.
HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def mmm_ulp_ratios(out, a, b) -> torch.Tensor:
    """|out − r| / (HALF_ULP·|r| + 2^-14·max|r|) element by element, where r
    is the float32 product of the same 16-bit inputs ``a`` and ``b``: the
    first term is rounding r to nearest, the second the float32 sum order
    where r is near 0.  A sound product of ``a`` and ``b`` rounded to
    nearest reads at most 1 everywhere."""
    r = a.float() @ b.float()
    bound = HALF_ULP[a.dtype] * r.abs() + 2.0 ** -14 * r.abs().max()
    diff = (out.float() - r).abs()
    return torch.where(diff == 0, torch.zeros_like(diff), diff / bound)


def mmm_ulp_excess(out, a, b) -> int:
    """How many elements of the 16-bit product ``out`` of ``a`` and ``b``
    lie past the bound of :func:`mmm_ulp_ratios`: half an output ulp of
    the float32 product plus its sum-order term.  A sound product rounded
    to nearest reads 0; one rounded toward zero, one with a K stage lost
    or a wrong swizzle moves many elements past the bound, where a
    normwise tolerance may not see them."""
    return int((mmm_ulp_ratios(out, a, b) > 1).sum())


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` does: 2^12 added to the
    magnitude's bit pattern (a carry moves into the exponent), then the low
    13 bits cleared.  Infinities and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """(hi, lo) of float32 ``x``: hi = tf32(x) and lo = tf32(x − hi), x − hi
    exact in float32, as the 3×TF32 route's split pass writes them.  A
    finite x that rounding would carry past the largest float32 takes hi by
    truncation, so x − hi stays finite; a non-finite x goes whole into lo
    (hi = 0), so that each product meets it once, as A @ B does."""
    hi = tf32_round(x)
    truncated = (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    hi = torch.where(torch.isinf(hi), truncated, hi)
    hi = torch.where(torch.isfinite(x), hi, torch.zeros_like(hi))
    return hi, tf32_round(x - hi)


def tf32x3_workspace(a, b, kp=None):
    """The 3×TF32 route's workspace as its split pass writes it, from
    float32 A (M x K) and B (K x N): ``ws_a`` = [A_hi; A_lo] (2M x Kp) and
    ``ws_b`` = [B_hi^T; B_lo^T] (2N x Kp) of the :func:`tf32_split` parts,
    Kp = K rounded up to 4 (``kp`` sets another width ≥ K), zeros in the
    columns K .. Kp − 1."""
    m, k = a.shape
    n = b.shape[1]
    kp = round_up(k, 4) if kp is None else kp
    ws_a = a.new_zeros((2 * m, kp))
    ws_b = a.new_zeros((2 * n, kp))
    ws_a[:m, :k], ws_a[m:, :k] = tf32_split(a)
    b_hi, b_lo = tf32_split(b.t())
    ws_b[:n, :k], ws_b[n:, :k] = b_hi, b_lo
    return ws_a, ws_b


def tf32x3_product(ws_a, ws_b):
    """C = A_lo·B_hi + A_hi·B_lo + A_hi·B_hi of a :func:`tf32x3_workspace`,
    three float32 products over its columns summed in float32 (A_lo·B_lo
    is left out, as the kernel leaves it out).  The pad columns meet pad
    columns only and add exact zeros.  The kernel sums the three terms per
    K step of 8, in another order."""
    m, n = ws_a.shape[0] // 2, ws_b.shape[0] // 2
    a_hi, a_lo, b_hi, b_lo = ws_a[:m], ws_a[m:], ws_b[:n].t(), ws_b[n:].t()
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mmm_tf32x3_ref(a, b):
    """The 3×TF32 route's plain model: :func:`tf32x3_product` of the padded
    :func:`tf32x3_workspace` of float32 ``a`` and ``b``."""
    return tf32x3_product(*tf32x3_workspace(a.float(), b.float()))


def pack_ref(x, cols_p):
    """The tensor-core route's pack pass: the rows of 16-bit ``x`` (rows x
    cols) copied bit for bit into rows of ``cols_p`` ≥ cols values, zeros
    in the columns cols .. cols_p − 1."""
    out = x.new_zeros((x.shape[0], cols_p))
    out[:, :x.shape[1]] = x
    return out


def mmm_splitk_ref(a, b, splits=None):
    """The skinny kernel's plain version: C = A @ B summed over K in the
    kernel's own segments (:func:`~.matmul.skinny_plan`, at ``splits``
    where a tuned plan gives one).  Each warp segment is one float32
    partial product; a block sums its warps' partials in warp order, the
    splits are summed in split order, all in float32, and the result is
    rounded once to A's type."""
    m, k = a.shape
    n = b.shape[1]
    splits, kb, kw = skinny_plan(m, n, k, a.element_size(), splits)
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
