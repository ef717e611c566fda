"""Plain PyTorch versions of FFT (port of ``repro.kernels.fft.ref``) and the
twiddle matrices of the DFT-by-matmul kernel."""
import math

import torch


def fft_ref(x):
    """DFT along the last axis of the float32 input → complex64: one
    ``torch.fft.fft`` (cuFFT on the card)."""
    return torch.fft.fft(x.float(), dim=-1).to(torch.complex64)


#: the fail-safe and the library row are the same one call
fft_aten = fft_ref


def twiddles(n: int, device) -> tuple:
    """(time, freq) float32 matrices cos and −sin of 2π·((t·k) mod n)/n.

    The product t·k is reduced mod n in int64 and the angle taken in
    float64, so each entry is rounded to float32 once.  (The reference forms
    the angle 2π/n·t·k in float32, which at n = 4096 is off by up to about
    1.5e-3 rad.)"""
    t = torch.arange(n, dtype=torch.int64, device=device)
    theta = (torch.outer(t, t) % n).double() * (2.0 * math.pi / n)
    return torch.cos(theta).float(), torch.sin(theta).neg_().float()


def dft_ref(x, c=None, s=None):
    """The kernel's plain version: re = x·C and im = x·S with the
    :func:`twiddles` (or the ``c``, ``s`` given), float32, as complex64 of
    x's shape."""
    n = x.shape[-1]
    if c is None:
        c, s = twiddles(n, x.device)
    xf = x.float()
    return torch.complex(xf @ c, xf @ s)
