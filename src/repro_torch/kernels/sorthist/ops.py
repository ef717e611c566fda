"""Public SORT and HIST: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ref import hist_ref, sort_ref
from .sorthist import hist_hopper, hist_problem, sort_hopper, sort_problem


def sort(x):
    """Ascending sort along the last axis, in x's type, NaN last."""
    if x.device.type == "cpu":
        _cuda.require(sort_problem(x), "SORT")
        return sort_ref(x)
    return sort_hopper(x)


def hist(x, *, bins: int = 64, lo: float = 0.0, hi: float = 1.0):
    """float32 counts, shape (bins,), of the flattened ``x`` over ``bins``
    equal buckets of ``[lo, hi]`` (the :func:`~.ref.bin_ids` contract)."""
    if x.device.type == "cpu":
        _cuda.require(hist_problem(x, bins, lo, hi), "HIST")
        return hist_ref(x, bins=bins, lo=lo, hi=hi)
    return hist_hopper(x, bins=bins, lo=lo, hi=hi)


def sort_supported(x, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes this operand."""
    return sort_problem(x) is None


def hist_supported(x, *, bins: int = 64, lo: float = 0.0, hi: float = 1.0,
                   **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes this operand."""
    return hist_problem(x, bins, lo, hi) is None
