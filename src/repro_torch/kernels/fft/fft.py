"""FFT on Hopper: the ctypes wrappers around ``csrc/fft_radix.cu`` and
``csrc/fft.cu``, and the route between them.

Replaces ``repro/kernels/fft/fft.py::fft_pallas``.  Two routes, chosen by the
transform length alone (:func:`fft_route`):

* ``radix`` (``fft_radix.cu``), for n a power of two: each real row as one
  n/2-point complex Stockham radix-4/2 FFT in shared memory and a
  post-pass, against a table of n twiddles;
* ``dft`` (``fft.cu``), for every other n: the reference's DFT, re = x·C
  and im = x·S against the n x n twiddle matrices, both accumulated in one
  pass over x, in 128-row x 64-frequency tiles.

Both kernels mask ragged edges and write complex64 interleaved, so the
wrappers pad and combine nothing.  Each route counts its own launches
(``fft_radix`` and ``fft``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("fft")
RADIX_LAUNCHES = _cuda.counter("fft_radix")

#: longest transform: the DFT route's twiddle matrices are n x n (the
#: reference's cap), the radix route's shared buffer holds 4096 values
MAX_N = 4096
_MAX_GRID_Y = 65535     # row tiles of 128


def fft_route(n: int) -> str:
    """``"radix"`` for n a power of two, else ``"dft"``."""
    return "radix" if n >= 1 and n & (n - 1) == 0 else "dft"


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
    if x.dim() == 2 and cdiv(x.shape[0], 128) > _MAX_GRID_Y:
        return f"{x.shape[0]} rows exceed the grid"
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


def fft_hopper(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """DFT of each row of ``x`` on the card against the float32 twiddles
    ``c``, ``s`` (n, n): complex64 of x's shape (the ``dft`` route; it takes
    any n up to :data:`MAX_N`)."""
    _cuda.require_cuda(fft_problem(x), "FFT", x)
    n = x.shape[-1]
    for name, t in (("C", c), ("S", s)):
        if t.dtype != torch.float32 or t.shape != (n, n) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"FFT: twiddle matrix {name} must be a contiguous "
                             f"float32 ({n}, {n}) tensor on {x.device}")
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    m = x.numel() // n
    if m == 0:
        return out
    rc = _cuda.lib().halo_fft(x.data_ptr(), c.data_ptr(), s.data_ptr(),
                              out.data_ptr(), m, n, _cuda.dtype_code(x.dtype),
                              _cuda.stream(x.device))
    _cuda.check(rc, "fft")
    LAUNCHES.add()
    # the twiddles may come from a cache that drops them before the kernel
    # is done: tell the allocator this stream still reads them
    stream = torch.cuda.current_stream(x.device)
    c.record_stream(stream)
    s.record_stream(stream)
    return out
