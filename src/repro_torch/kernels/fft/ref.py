"""Plain PyTorch versions of FFT (port of ``repro.kernels.fft.ref``): the
library call, the radix route's Stockham stages and its twiddle table, and
the DFT route's product by twiddle matrices."""
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


def radix_twiddles(n: int, device) -> torch.Tensor:
    """(n,) complex64 table w^j = exp(−2πi·j/n), the angle taken in float64
    and each part rounded to float32 once, as :func:`twiddles` does."""
    theta = torch.arange(n, dtype=torch.float64, device=device) * (2.0 * math.pi / n)
    return torch.complex(torch.cos(theta).float(), torch.sin(theta).neg_().float())


def radix_plan(h: int) -> list:
    """The radices of the stages of an h-point FFT, h = 2^j, in order: a
    radix-2 stage first when j is odd, then radix-4 stages."""
    j = h.bit_length() - 1
    return [2] * (j % 2) + [4] * (j // 2)


def fft_radix_ref(x, tw=None):
    """The radix kernel's plain version, in the same steps and order as
    ``csrc/fft_radix.cu`` on every row at once, in complex64: the n/2-point
    Stockham FFT Z of z[t] = x[2t] + i·x[2t+1] (stage R with p the length
    of the sub-transforms done so far: for each butterfly i < h/R,
    u_r = buf[i + r·h/R] times w_h^(r·k·h/(R·p)) with k = i mod p, an
    R-point DFT, buf'[(i − k)·R + k + r·p] = v_r), then
    X[k] = E + w^k·O and X[k + n/2] = E − w^k·O with
    E = (Z[k] + conj(Z[h−k]))/2 and O = −i·(Z[k] − conj(Z[h−k]))/2."""
    n = x.shape[-1]
    if tw is None:
        tw = radix_twiddles(n, x.device)
    xf = x.reshape(-1, n).float()
    if n == 1:
        return xf.to(torch.complex64).reshape(x.shape)
    h = n // 2
    buf = torch.complex(xf[:, 0::2], xf[:, 1::2])
    p = 1
    for r_ in radix_plan(h):
        nb = h // r_
        i = torch.arange(nb, device=x.device)
        k = i & (p - 1)
        step = n // (r_ * p)              # w_h^e is entry 2e of the n-table
        u = [buf[:, i + r * nb] for r in range(r_)]
        u = [u[0]] + [u[r] * tw[r * k * step] for r in range(1, r_)]
        if r_ == 2:
            v = [u[0] + u[1], u[0] - u[1]]
        else:
            a0, a1 = u[0] + u[2], u[0] - u[2]
            a2, a3 = u[1] + u[3], u[1] - u[3]
            mi_a3 = torch.complex(a3.imag, -a3.real)          # −i·a3
            v = [a0 + a2, a1 + mi_a3, a0 - a2, a1 - mi_a3]
        j = (i - k) * r_ + k
        nxt = torch.empty_like(buf)
        for r in range(r_):
            nxt[:, j + r * p] = v[r]
        buf, p = nxt, p * r_
    k = torch.arange(h, device=x.device)
    zk, zm = buf, buf[:, (h - k) & (h - 1)]
    e = torch.complex((zk.real + zm.real) * 0.5, (zk.imag - zm.imag) * 0.5)
    od = torch.complex((zk.imag + zm.imag) * 0.5, (zm.real - zk.real) * 0.5)
    wo = od * tw[:h]
    return torch.cat([e + wo, e - wo], dim=-1).reshape(x.shape)
