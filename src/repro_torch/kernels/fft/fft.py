"""FFT on Hopper: the ctypes wrappers around ``csrc/fft_radix.cu`` and
``csrc/fft_chirp.cu``, and the route between them.

Replaces ``repro/kernels/fft/fft.py::fft_pallas``.  Two routes, chosen by the
transform length alone (:func:`fft_route`):

* ``radix`` (``fft_radix.cu``), for n a power of two: each real row as one
  n/2-point complex Stockham radix-4/2 FFT in shared memory and a
  post-pass, against a table of n twiddles;
* ``chirp`` (``fft_chirp.cu``), for every other n: Bluestein's chirp-z
  identity, the row times a chirp as one circular convolution of length L
  (the least power of two ≥ 2n − 1), by two L-point Stockham FFTs in
  shared memory around a product with the filter's spectrum, against the
  tables of :func:`~.ref.chirp_tables`.

Both kernels mask ragged edges and write complex64 interleaved, so the
wrappers pad and combine nothing.  Each route counts its own launches
(``fft_radix`` and ``fft_chirp``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from .ref import ChirpTables, chirp_length

RADIX_LAUNCHES = _cuda.counter("fft_radix")
CHIRP_LAUNCHES = _cuda.counter("fft_chirp")

#: longest transform (the reference's cap): the radix route's shared buffer
#: holds 4096 values, the chirp route's 8192 (L at n = 4095)
MAX_N = 4096
_MAX_ROWS = 2**31 - 1


def fft_route(n: int) -> str:
    """``"radix"`` for n a power of two, else ``"chirp"``."""
    return "radix" if n >= 1 and n & (n - 1) == 0 else "chirp"


def fft_problem(x) -> Optional[str]:
    """Why the FFT kernel cannot take ``x``, or None."""
    why = _cuda.operand_problem((x,))
    if why:
        return why
    if x.dim() not in (1, 2):
        return f"FFT takes an (n,) or (m, n) input, got {x.dim()}-D"
    n = x.shape[-1]
    if not 1 <= n <= MAX_N:
        return f"FFT needs 1 <= n <= {MAX_N}, got n={n}"
    if x.numel() // n > _MAX_ROWS:
        return f"{x.numel() // n} rows exceed the grid"
    return None


def fft_radix_hopper(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """FFT of each row of ``x`` on the card, n a power of two, against the
    complex64 twiddle table ``tw`` (n,) of :func:`~.ref.radix_twiddles`:
    complex64 of x's shape."""
    _cuda.require_cuda(fft_problem(x), "FFT", x)
    n = x.shape[-1]
    if fft_route(n) != "radix":
        raise ValueError(f"FFT: the radix route takes n a power of two, got n={n}")
    if tw.dtype != torch.complex64 or tw.shape != (n,) or tw.device != x.device \
            or not tw.is_contiguous():
        raise ValueError(f"FFT: the twiddle table must be a contiguous "
                         f"complex64 ({n},) tensor on {x.device}")
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    m = x.numel() // n
    if m == 0:
        return out
    rc = _cuda.lib().halo_fft_radix(x.data_ptr(), tw.data_ptr(), out.data_ptr(),
                                    m, n, int(_cuda.aligned(x)),
                                    _cuda.dtype_code(x.dtype), _cuda.stream(x.device))
    _cuda.check(rc, "fft_radix")
    RADIX_LAUNCHES.add()
    # the table may come from a cache that drops it before the kernel is
    # done: tell the allocator this stream still reads it
    tw.record_stream(torch.cuda.current_stream(x.device))
    return out


def fft_chirp_hopper(x: torch.Tensor, tables: ChirpTables) -> torch.Tensor:
    """FFT of each row of ``x`` on the card, n not a power of two, against
    the :class:`~.ref.ChirpTables` of n on x's device: complex64 of x's
    shape."""
    _cuda.require_cuda(fft_problem(x), "FFT", x)
    n = x.shape[-1]
    if fft_route(n) != "chirp":
        raise ValueError(f"FFT: the chirp route takes n not a power of two, got n={n}")
    L = chirp_length(n)
    for name, t, size in (("chirp", tables.chirp, n), ("spectrum", tables.spectrum, L),
                          ("twiddles", tables.twiddles, L)):
        if t.dtype != torch.complex64 or t.shape != (size,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"FFT: the {name} table must be a contiguous "
                             f"complex64 ({size},) tensor on {x.device}")
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    m = x.numel() // n
    if m == 0:
        return out
    rc = _cuda.lib().halo_fft_chirp(x.data_ptr(), tables.chirp.data_ptr(),
                                    tables.spectrum.data_ptr(), tables.twiddles.data_ptr(),
                                    out.data_ptr(), m, n, _cuda.dtype_code(x.dtype),
                                    _cuda.stream(x.device))
    _cuda.check(rc, "fft_chirp")
    CHIRP_LAUNCHES.add()
    # the tables may come from a cache that drops them before the kernel is
    # done: tell the allocator this stream still reads them
    stream = torch.cuda.current_stream(x.device)
    for t in tables:
        t.record_stream(stream)
    return out
