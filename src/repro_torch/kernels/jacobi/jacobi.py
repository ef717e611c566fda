"""JS on Hopper: the ctypes wrapper around ``csrc/jacobi.cu``.

Replaces ``repro/kernels/jacobi/jacobi.py::jacobi_step_pallas``.  One fused
pass over A: one warp per row sums the row's off-diagonal products in
float32, and the row's last step reads diag(A) and writes
x' = (b − (A·x − d∘x))/d.  Leaving d∘x out of the sum, rather than adding
and subtracting it, keeps its rounding out of x'.  Ragged rows are masked,
so A is not padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _cuda

LAUNCHES = _cuda.counter("jacobi")


def jacobi_problem(a, x, b) -> Optional[str]:
    """Why the JS kernel cannot take ``(a, x, b)``, or None."""
    why = _cuda.operand_problem((a, x, b))
    if why:
        return why
    if a.dim() != 2 or x.dim() != 1 or b.dim() != 1:
        return (f"JS takes A (n,n), x (n,) and b (n,), got {a.dim()}-D, "
                f"{x.dim()}-D and {b.dim()}-D")
    if a.shape[0] != a.shape[1]:
        return f"JS takes a square A, got {tuple(a.shape)}"
    if x.shape[0] != a.shape[0] or b.shape[0] != a.shape[0]:
        return (f"JS sizes differ: A {tuple(a.shape)}, x {tuple(x.shape)}, "
                f"b {tuple(b.shape)}")
    if a.shape[0] >= 2**31:
        return f"shape {tuple(a.shape)} exceeds the kernel's int indices"
    return None


def jacobi_hopper(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep on the card: x' (n,) in x's type."""
    _cuda.require_cuda(jacobi_problem(a, x, b), "JS", a)
    n = a.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    vec = _cuda.aligned(a, x) and (n * a.element_size()) % 16 == 0
    rc = _cuda.lib().halo_jacobi(a.data_ptr(), x.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), n, _cuda.dtype_code(a.dtype),
                                 int(vec), _cuda.stream(a.device))
    _cuda.check(rc, "jacobi")
    LAUNCHES.add()
    return out
