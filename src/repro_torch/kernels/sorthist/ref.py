"""Plain PyTorch oracles for SORT and HIST (port of
``repro.kernels.sorthist.ref``), and the SORT radix route's plain model."""
import torch

#: key bits each type keeps (csrc/sort_radix.cu's KeyMask): below a 16-bit
#: type's mantissa they are 0 for every positive and 1 for every negative
#: value, so clearing them keeps the order and makes the low digits constant
KEY_MASK = {torch.float32: 0xFFFFFFFF, torch.bfloat16: 0xFFFF0000,
            torch.float16: 0xFFFFE000}
#: the key of every NaN, above +inf's
NAN_KEY = 0xFFFFFFFE
#: the radix route's digit passes, of 8 bits each
RADIX_PASSES = 4


def sort_ref(x):
    """Ascending sort along the last axis, every NaN last, as ``jnp.sort``
    (the fail-safe).  Each NaN is first made the one positive NaN: on the
    card ``torch.sort`` puts a NaN whose sign bit is set first."""
    return torch.sort(x.masked_fill(x.isnan(), float("nan")), dim=-1).values


def sort_keys(x) -> torch.Tensor:
    """The radix route's keys of ``x`` as int64 in [0, 2^32): the float32
    value's bits with the sign flipped for positives and every bit flipped
    for negatives, every NaN at :data:`NAN_KEY`, masked by
    :data:`KEY_MASK` of x's type.  Unsigned order is the order of the
    values, −0 below +0 and NaN last."""
    u = x.float().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    key = torch.where(x.isnan(), NAN_KEY, key)
    return key & KEY_MASK[x.dtype]


def keys_to_values(keys: torch.Tensor, dtype) -> torch.Tensor:
    """The values of :func:`sort_keys` keys in ``dtype`` (every NaN the one
    positive NaN); exact."""
    mask = KEY_MASK[dtype]
    u = torch.where(keys >= 0x80000000, keys & 0x7FFFFFFF, keys ^ 0xFFFFFFFF) & mask
    u = torch.where(keys >= (NAN_KEY & mask), 0x7FC00000, u)
    bits = (u - ((u >= 0x80000000).long() << 32)).to(torch.int32)
    return bits.view(torch.float32).to(dtype)


def radix_passes(keys: torch.Tensor) -> tuple:
    """The digit passes a row of :func:`sort_keys` keys takes: those whose
    8-bit digit is not the same for every key (the kernel then runs one
    stable copy for a row whose passes are all skipped)."""
    return tuple(p for p in range(RADIX_PASSES)
                 if bool((((keys >> (8 * p)) & 255) != ((keys[:1] >> (8 * p)) & 255)).any()))


def sort_radix_ref(x):
    """The radix route's plain model, in the kernel's steps: keys of
    :func:`sort_keys`, then for each digit pass from the least significant
    a stable scatter by the digit of every row whose digit is not constant
    (the others skip it), then the values back in x's type."""
    if x.numel() == 0:
        return torch.empty_like(x)
    n = x.shape[-1]
    keys = sort_keys(x).reshape(-1, n)
    for p in range(RADIX_PASSES):
        d = (keys >> (8 * p)) & 255
        runs = (d != d[:, :1]).any(-1)
        if bool(runs.any()):
            order = torch.argsort(d[runs], dim=-1, stable=True)
            keys[runs] = torch.gather(keys[runs], -1, order)
    return keys_to_values(keys, x.dtype).reshape(x.shape)


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
