"""FFT on Hopper: the ctypes wrapper around ``csrc/fft.cu``.

Replaces ``repro/kernels/fft/fft.py::fft_pallas``: the DFT of each row as
re = x·C and im = x·S against the twiddle matrices, both accumulated in one
pass over x.  The kernel tiles 128 rows x 64 frequencies with a
shared-memory time loop, masks ragged edges, and writes complex64
interleaved, so the wrapper pads and combines nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda
from ..common import cdiv

LAUNCHES = _cuda.counter("fft")

#: longest transform: the twiddle matrices are n x n (the reference's cap)
MAX_N = 4096
_MAX_GRID_Y = 65535     # row tiles of 128


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


def fft_hopper(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """DFT of each row of ``x`` on the card against the float32 twiddles
    ``c``, ``s`` (n, n): complex64 of x's shape."""
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
