"""Public FFT: the Hopper kernel for CUDA tensors, the plain version for CPU
tensors, and the twiddle cache."""
from __future__ import annotations

import functools

from .. import _cuda
from .fft import fft_hopper, fft_problem
from .ref import dft_ref, twiddles


@functools.lru_cache(maxsize=2)
def cached_twiddles(n: int, device):
    """:func:`~.ref.twiddles` for ``(n, device)``, the two most recently used
    kept: one n = 4096 pair is 128 MB, so at most 256 MB."""
    return twiddles(n, device)


def fft(x):
    """DFT along the last axis of a real (n,) or (m, n) input, n ≤ 4096 →
    complex64 of the same shape (the DFT by twiddle matrices)."""
    _cuda.require(fft_problem(x), "FFT")
    c, s = cached_twiddles(x.shape[-1], x.device)
    if x.device.type == "cpu":
        return dft_ref(x, c, s)
    return fft_hopper(x, c, s)


def fft_supported(x, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes this operand."""
    return fft_problem(x) is None
