"""Public FFT: the Hopper kernels for CUDA tensors, their plain versions for
CPU tensors, by the route of :func:`~.fft.fft_route`, and the table
caches."""
from __future__ import annotations

import functools

from .. import _cuda
from .fft import fft_chirp_hopper, fft_problem, fft_radix_hopper, fft_route
from .ref import chirp_tables, fft_chirp_ref, fft_radix_ref, radix_twiddles


@functools.lru_cache(maxsize=8)
def cached_radix_twiddles(n: int, device):
    """:func:`~.ref.radix_twiddles` for ``(n, device)``: 32 KB at n = 4096."""
    return radix_twiddles(n, device)


@functools.lru_cache(maxsize=8)
def cached_chirp_tables(n: int, device):
    """:func:`~.ref.chirp_tables` for ``(n, device)``: at most 160 KB (n =
    4095, L = 8192)."""
    return chirp_tables(n, device)


def fft(x):
    """DFT along the last axis of a real (n,) or (m, n) input, n ≤ 4096 →
    complex64 of the same shape: the radix FFT for n a power of two, the
    chirp-z FFT for other n."""
    _cuda.require(fft_problem(x), "FFT")
    n = x.shape[-1]
    if fft_route(n) == "radix":
        tw = cached_radix_twiddles(n, x.device)
        if x.device.type == "cpu":
            return fft_radix_ref(x, tw)
        return fft_radix_hopper(x, tw)
    tables = cached_chirp_tables(n, x.device)
    if x.device.type == "cpu":
        return fft_chirp_ref(x, tables)
    return fft_chirp_hopper(x, tables)


def fft_supported(x, **kw) -> bool:
    """Feasibility of the hopper row: a kernel takes this operand."""
    return fft_problem(x) is None
