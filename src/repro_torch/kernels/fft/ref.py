"""Plain PyTorch versions of FFT (port of ``repro.kernels.fft.ref``): the
library call, the radix route's Stockham stages and its twiddle table, and
the chirp route's tables and steps."""
import math
from typing import NamedTuple

import torch


def fft_ref(x):
    """DFT along the last axis of the float32 input → complex64: one
    ``torch.fft.fft`` (cuFFT on the card)."""
    return torch.fft.fft(x.float(), dim=-1).to(torch.complex64)


#: the fail-safe and the library row are the same one call
fft_aten = fft_ref


def radix_twiddles(n: int, device) -> torch.Tensor:
    """(n,) complex64 table w^j = exp(−2πi·j/n), the angle taken in float64
    and each part rounded to float32 once.  (The reference forms its angles
    in float32, which at n = 4096 is off by up to about 1.5e-3 rad.)"""
    theta = torch.arange(n, dtype=torch.float64, device=device) * (2.0 * math.pi / n)
    return torch.complex(torch.cos(theta).float(), torch.sin(theta).neg_().float())


def radix_plan(h: int) -> list:
    """The radices of the stages of an h-point FFT, h = 2^j, in order: a
    radix-2 stage first when j is odd, then radix-4 stages."""
    j = h.bit_length() - 1
    return [2] * (j % 2) + [4] * (j // 2)


def stockham_ref(buf, tw):
    """The h-point FFT of each row of the complex64 ``buf`` (m, h), h = 2^j,
    in the kernels' Stockham stages and order (``csrc/fft_stockham.cuh``),
    against a table ``tw`` of nt = c·h twiddles w^e = exp(−2πi·e/nt): stage
    R, with p the length of the sub-transforms done so far, multiplies
    u_r = buf[i + r·h/R] of butterfly i < h/R by w_h^(r·k·h/(R·p)), entry
    r·k·nt/(R·p) of the table, with k = i mod p, takes the R-point DFT and
    writes it to buf'[(i − k)·R + k + r·p]."""
    h, nt = buf.shape[-1], tw.shape[0]
    p = 1
    for r_ in radix_plan(h):
        nb = h // r_
        i = torch.arange(nb, device=buf.device)
        k = i & (p - 1)
        step = nt // (r_ * p)
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
    return buf


def fft_radix_ref(x, tw=None):
    """The radix kernel's plain version, in the same steps and order as
    ``csrc/fft_radix.cu`` on every row at once, in complex64: the n/2-point
    Stockham FFT Z of z[t] = x[2t] + i·x[2t+1] (:func:`stockham_ref`), then
    X[k] = E + w^k·O and X[k + n/2] = E − w^k·O with
    E = (Z[k] + conj(Z[h−k]))/2 and O = −i·(Z[k] − conj(Z[h−k]))/2."""
    n = x.shape[-1]
    if tw is None:
        tw = radix_twiddles(n, x.device)
    xf = x.reshape(-1, n).float()
    if n == 1:
        return xf.to(torch.complex64).reshape(x.shape)
    h = n // 2
    buf = stockham_ref(torch.complex(xf[:, 0::2], xf[:, 1::2]), tw)
    k = torch.arange(h, device=x.device)
    zk, zm = buf, buf[:, (h - k) & (h - 1)]
    e = torch.complex((zk.real + zm.real) * 0.5, (zk.imag - zm.imag) * 0.5)
    od = torch.complex((zk.imag + zm.imag) * 0.5, (zm.real - zk.real) * 0.5)
    wo = od * tw[:h]
    return torch.cat([e + wo, e - wo], dim=-1).reshape(x.shape)


def chirp_length(n: int) -> int:
    """L of the chirp route: the least power of two ≥ 2n − 1, which holds
    the circular convolution of two sequences of n values."""
    return 1 << (2 * n - 2).bit_length()


class ChirpTables(NamedTuple):
    """The chirp route's tables for one n, all complex64: ``chirp`` (n,)
    b_j = exp(−iπ·j²/n); ``spectrum`` (L,) H, the L-point FFT of the wrapped
    filter h_j = conj(b_|j|), scaled by 1/L; ``twiddles`` (L,) the L-point
    table of :func:`radix_twiddles`."""
    chirp: torch.Tensor
    spectrum: torch.Tensor
    twiddles: torch.Tensor


def chirp_tables(n: int, device) -> ChirpTables:
    """:class:`ChirpTables` for n.  j² is reduced mod 2n in int64 (b_j
    depends on j² mod 2n alone) and the angle π·(j² mod 2n)/n taken in
    float64, and each part rounded to float32 once; H is computed in
    float64 from the float64 chirp (one ``torch.fft.fft``, which builds a
    constant as ``torch.cos`` builds the twiddles), scaled by 1/L there and
    rounded once."""
    L = chirp_length(n)
    j = torch.arange(n, dtype=torch.int64, device=device)
    theta = ((j * j) % (2 * n)).double() * (math.pi / n)
    b64 = torch.complex(torch.cos(theta), -torch.sin(theta))
    h = torch.zeros(L, dtype=torch.complex128, device=device)
    h[:n] = b64.conj()
    h[L - n + 1:] = b64[1:].conj().flip(0)
    spectrum = torch.fft.fft(h) / L
    return ChirpTables(b64.to(torch.complex64), spectrum.to(torch.complex64),
                       radix_twiddles(L, device))


def fft_chirp_ref(x, tables=None):
    """The chirp kernel's plain version, in the same steps and order as
    ``csrc/fft_chirp.cu`` on every row at once, in complex64: a = x·b
    zero-padded to L; A = the L-point Stockham FFT of a
    (:func:`stockham_ref`); conj(A·H); its L-point FFT D, so that conj(D)
    is the inverse FFT of A·H times L (H holds the 1/L); X[k] = b_k·conj(D_k)
    for k < n."""
    n = x.shape[-1]
    if tables is None:
        tables = chirp_tables(n, x.device)
    b, spectrum, tw = tables
    L = spectrum.shape[0]
    xf = x.reshape(-1, n).float()
    a = torch.zeros((xf.shape[0], L), dtype=torch.complex64, device=x.device)
    a[:, :n] = torch.complex(xf * b.real, xf * b.imag)
    c = stockham_ref(a, tw) * spectrum
    d = stockham_ref(c.conj(), tw)[:, :n].conj()
    return (d * b).reshape(x.shape)
