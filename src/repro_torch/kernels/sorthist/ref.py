"""Plain PyTorch oracles for SORT and HIST (port of
``repro.kernels.sorthist.ref``)."""
import torch


def sort_ref(x):
    """Ascending sort along the last axis, every NaN last, as ``jnp.sort``
    (the fail-safe).  Each NaN is first made the one positive NaN: on the
    card ``torch.sort`` puts a NaN whose sign bit is set first."""
    return torch.sort(x.masked_fill(x.isnan(), float("nan")), dim=-1).values


def sort_aten(x):
    """The library row: one ``torch.sort`` (CUB's radix sort on the card,
    which puts a NaN whose sign bit is set first)."""
    return torch.sort(x, dim=-1).values


def bin_ids(x, bins: int, lo: float, hi: float) -> torch.Tensor:
    """Bin of every value of ``x`` that falls in ``[lo, hi]``, as int64.

    The HIST binning contract of the reference: ``lo``, ``hi`` and
    ``width = (hi - lo) / bins`` (worked out in float64) are used as float32
    values; a value's bin is ``floor((x - lo) / width)`` with an IEEE
    float32 division, clipped into ``[0, bins - 1]``; values outside
    ``[lo, hi]`` (NaN included) are dropped, so the right edge is closed.
    The clip is taken in float32 on the kept values only, so no NaN or
    infinity reaches a conversion to an integer."""
    xf = x.reshape(-1).float()
    f32 = dict(dtype=torch.float32, device=xf.device)
    lo32, hi32 = torch.tensor(lo, **f32), torch.tensor(hi, **f32)
    width = torch.tensor((hi - lo) / bins, **f32)
    valid = (xf >= lo32) & (xf <= hi32)
    q = torch.floor((xf[valid] - lo32) / width)
    return q.clamp_(0, bins - 1).long()


def hist_ref(x, *, bins: int = 64, lo: float = 0.0, hi: float = 1.0):
    """float32 counts, shape (bins,), of the flattened ``x`` under the
    :func:`bin_ids` contract: one ``torch.bincount`` (the fail-safe).
    Counts are exact while every bin holds fewer than 2^24 values."""
    return torch.bincount(bin_ids(x, bins, lo, hi), minlength=bins).float()


def hist_aten(x, *, bins: int = 64, lo: float = 0.0, hi: float = 1.0):
    """The library row: the same binning through one ATen scatter
    (``index_add_`` of ones into int64 counts).  ``torch.histc`` is no row:
    it bins the edges differently."""
    ids = bin_ids(x, bins, lo, hi)
    counts = torch.zeros(bins, dtype=torch.int64, device=ids.device)
    return counts.index_add_(0, ids, torch.ones_like(ids)).float()
