"""Plain PyTorch oracle for MMM (port of ``repro.kernels.matmul.ref``)."""
import torch


def mmm_ref(a, b):
    """C = A @ B with float32 accumulation, in A's type (the fail-safe)."""
    return (a.float() @ b.float()).to(a.dtype)


def mmm_aten(a, b):
    """The library row: one ``torch.matmul`` in the operands' type (cuBLAS
    on the card), as the reference's XLA row emits its dot in the operand
    type."""
    return torch.matmul(a, b)
