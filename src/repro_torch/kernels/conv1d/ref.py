"""Plain PyTorch oracle for 1DCONV, the valid 1-D convolution in
correlation form (port of ``repro.kernels.conv1d.ref``)."""
import torch
import torch.nn.functional as F


def conv1d_ref(x, w):
    """Valid cross-correlation out[i] = Σₖ x[i+k]·w[k] for i < N − K + 1:
    float32, accumulated tap by tap in order, in x's type (the fail-safe)."""
    n, k = x.shape[0], w.shape[0]
    xf, wf = x.float(), w.float()
    out = torch.zeros(n - k + 1, dtype=torch.float32, device=x.device)
    for t in range(k):
        out += wf[t] * xf[t:t + n - k + 1]
    return out.to(x.dtype)


def conv1d_aten(x, w):
    """The library row: one ``F.conv1d`` of (1, 1, N) by (1, 1, K) in the
    operands' type.  On the card a float32 convolution goes to cuDNN, which
    computes in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False
    (``chip_smoke.py`` sets it False before it compares or times)."""
    return F.conv1d(x.view(1, 1, -1), w.view(1, 1, -1)).view(-1)
