"""Plain PyTorch oracles for SORT and HIST (port of
``repro.kernels.sorthist.ref``), and the plain models of SORT's two routes."""
import torch

#: key bits each type keeps (csrc/sort_radix.cu's KeyMask): below a 16-bit
#: type's mantissa they are 0 for every positive and 1 for every negative
#: value, so clearing them keeps the order and makes the low digits constant
KEY_MASK = {torch.float32: 0xFFFFFFFF, torch.bfloat16: 0xFFFF0000,
            torch.float16: 0xFFFFE000}
#: the key of every NaN, above +inf's
NAN_KEY = 0xFFFFFFFE
#: the tile route's key for the places from n up to the row's power of
#: two, above every NaN's
PAD_KEY = 0xFFFFFFFF
#: the radix route's digit passes, of 8 bits each
RADIX_PASSES = 4
#: lanes of a warp
WARP = 32


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


def _slot_step(key, j, up):
    """Compare-exchange of slots s and s + j (s & j = 0) in every thread:
    the lower slot takes the smaller key where ``up``, the larger elsewhere."""
    slots = torch.arange(key.shape[-1], device=key.device)
    lo = slots[(slots & j) == 0]
    a, b = key[..., lo], key[..., lo + j]
    small, large = torch.minimum(a, b), torch.maximum(a, b)
    out = key.clone()
    out[..., lo] = torch.where(up, small, large)
    out[..., lo + j] = torch.where(up, large, small)
    return out


def _thread_step(key, m):
    """Compare-exchange of each slot with the same slot of thread t ^ m: the
    lower thread keeps the smaller key.  The kernel takes its partner's key
    by ``__shfl_xor_sync`` within a warp (m < 32), and past a warp's span
    through the row's shared buffer (thread t writes slot s to word
    s·T + t and reads word s·T + (t ^ m))."""
    lane = torch.arange(key.shape[1], device=key.device)
    partner = key[:, lane ^ m, :]
    lower = ((lane & m) == 0)[:, None]
    return torch.where(lower, torch.minimum(key, partner), torch.maximum(key, partner))


def sort_tile_ref(x, plan):
    """The tile route's plain model under a launch plan
    (``sorthist.sort_tile_plan``), in the kernel's steps.  Keys of
    :func:`sort_keys` of x's float32 values (no mask), :data:`PAD_KEY` from
    n up to E·T places, held as (rows, T threads, E slots), loaded striped
    as a row off the 16-byte grid is: slot s of thread t takes element
    s·T + t (an aligned row's 16-byte loads start each key at its own
    place, which changes no bit of the sorted row).  The network orders
    place t·E + s, slot s of thread t, and the row is stored in place
    order.  The bitonic network runs stage k = 2, 4, …, E·T
    with strides j = k/2, …, 1.  Stages k ≤ E lie in one thread's slots,
    the direction by place.  In a later stage every place of a thread has
    one direction, ((t·E) & k) = 0 ascending, so the thread complements its
    keys for a descending stage, sorts ascending, and complements back; its
    strides from 32·E up exchange through shared memory, from E up by lane
    shuffles, below E between slots.  Rows past the plan's blocks are NaN;
    keys decode as ``from_key`` does (every NaN the one positive NaN)."""
    if x.numel() == 0:
        return torch.empty_like(x)
    n = x.shape[-1]
    rows = x.numel() // n
    e, t, r, blocks = plan
    places = e * t
    live = min(rows, blocks * r)
    dev = x.device
    held = torch.full((live, places), PAD_KEY, dtype=torch.int64, device=dev)
    held[:, :n] = sort_keys(x.reshape(rows, n)[:live].float())
    key = held.reshape(live, e, t).transpose(1, 2)          # the striped load
    place = torch.arange(places, device=dev).reshape(t, e)
    lane = torch.arange(t, device=dev)
    k = 2
    while k <= places:
        j = k // 2
        if k <= e:
            while j:
                up = ((place & k) == 0)[:, (torch.arange(e, device=dev) & j) == 0]
                key = _slot_step(key, j, up)
                j //= 2
        else:
            flip = torch.where((lane * e & k) == 0, 0, PAD_KEY)[:, None]
            key = key ^ flip
            while j >= WARP * e:                        # shared memory
                key = _thread_step(key, j // e)
                j //= 2
            while j >= e:                               # lane shuffles
                key = _thread_step(key, j // e)
                j //= 2
            while j:
                key = _slot_step(key, j, torch.tensor(True, device=dev))
                j //= 2
            key = key ^ flip
        k *= 2
    out = torch.full((rows, n), float("nan"), device=dev)
    out[:live] = keys_to_values(key.reshape(live, places)[:, :n], torch.float32)
    return out.to(x.dtype).reshape(x.shape)


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
