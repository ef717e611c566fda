"""Plain PyTorch oracle for RMSNORM (port of ``repro.kernels.rmsnorm.ref``)."""
import torch
import torch.nn.functional as F


def rmsnorm_ref(x, gamma, eps: float = 1e-6):
    """x · rsqrt(mean(x²) + eps) · γ over the last dim, in float32, returned
    in x's type (the fail-safe)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.float()
    return out.to(x.dtype)


def rmsnorm_aten(x, gamma, eps: float = 1e-6):
    """The library row: one ``torch.nn.functional.rms_norm`` call."""
    return F.rms_norm(x, (x.shape[-1],), gamma, eps)
