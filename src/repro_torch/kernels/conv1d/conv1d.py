"""1DCONV on Hopper: the ctypes wrapper around ``csrc/conv1d.cu``.

Replaces ``repro/kernels/conv1d/conv1d.py::conv1d_pallas``.  Each block
stages its output tile's slice of the signal (plus a K−1 halo) and the taps
in shared memory, 1024 taps at a time, so the tap count is a runtime value;
the output edge is masked, so the signal is not padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("conv1d")


def conv1d_problem(x, w) -> Optional[str]:
    """Why the 1DCONV kernel cannot take ``(x, w)``, or None."""
    why = _cuda.operand_problem((x, w))
    if why:
        return why
    if x.dim() != 1 or w.dim() != 1:
        return (f"1DCONV takes a signal (N,) and taps (K,), got {x.dim()}-D "
                f"and {w.dim()}-D")
    if not 1 <= w.shape[0] <= x.shape[0]:
        return f"1DCONV needs 1 <= K <= N, got K={w.shape[0]}, N={x.shape[0]}"
    return None


def conv1d_hopper(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation on the card: (N − K + 1,) in x's type."""
    _cuda.require_cuda(conv1d_problem(x, w), "1DCONV", x)
    n, k = x.shape[0], w.shape[0]
    out = torch.empty((n - k + 1,), dtype=x.dtype, device=x.device)
    rc = _cuda.lib().halo_conv1d(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 n, k, _cuda.dtype_code(x.dtype),
                                 _cuda.stream(x.device))
    _cuda.check(rc, "conv1d")
    LAUNCHES.add()
    return out
