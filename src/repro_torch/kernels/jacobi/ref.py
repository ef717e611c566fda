"""Plain PyTorch oracle for JS, the Jacobi solver on Ax = b (port of
``repro.kernels.jacobi.ref``)."""
import torch


def _sweep_tail(ax, a, x, b):
    """x' = (b − (A·x − d∘x)) / d in float32, in x's type; ``ax`` is A·x."""
    d = a.diagonal().float()
    r = ax.float() - d * x.float()
    return ((b.float() - r) / d).to(x.dtype)


def jacobi_step_ref(a, x, b):
    """One Jacobi sweep, x' = (b − (A − diag(A))·x) / diag(A): float32
    products summed per row, the result in x's type (the fail-safe)."""
    return _sweep_tail((a.float() * x.float()).sum(dim=1), a, x, b)


def jacobi_solve_ref(a, b, iters: int = 20, x0=None):
    """``iters`` sweeps of :func:`jacobi_step_ref` from ``x0`` (zeros)."""
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iters):
        x = jacobi_step_ref(a, x, b)
    return x


def jacobi_step_aten(a, x, b):
    """The library row: one ``torch.mv`` in the operands' type, then the
    same float32 tail as the oracle."""
    return _sweep_tail(torch.mv(a, x), a, x, b)

