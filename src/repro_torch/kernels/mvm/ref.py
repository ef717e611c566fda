"""Plain PyTorch oracle for MVM (port of ``repro.kernels.mvm.ref``)."""
import torch


def mvm_ref(a, x):
    """y = A @ x, float32 products summed per row, in A's type."""
    return (a.float() * x.float()).sum(dim=1).to(a.dtype)


def mvm_aten(a, x):
    """The library row: one ``torch.mv`` in the operands' type."""
    return torch.mv(a, x)
