"""Public SORT and HIST: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ref import hist_ref, sort_ref
from .sorthist import check_plan, hist_hopper, hist_problem, sort_hopper, sort_problem


def sort(x, *, rows_per_block=None):
    """Ascending sort along the last axis, in x's type, NaN last.
    ``rows_per_block`` is a tuned launch plan's (:func:`~.sorthist.sort_space`);
    on the CPU it is only checked."""
    if x.device.type == "cpu":
        _cuda.require(sort_problem(x), "SORT")
        check_plan(x, rows_per_block)
        return sort_ref(x)
    return sort_hopper(x, rows_per_block)


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
