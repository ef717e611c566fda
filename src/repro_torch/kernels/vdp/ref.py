"""Plain PyTorch oracle for VDP (port of ``repro.kernels.vdp.ref``)."""
import torch


def vdp_ref(x, y):
    """Σ x·y in float32: a 0-d float32 tensor."""
    return (x.float() * y.float()).sum()


def vdp_aten(x, y):
    """The library row: one ``torch.dot`` of float32 operands."""
    return torch.dot(x.float(), y.float())
