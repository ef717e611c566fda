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


def rmsnorm_plan_ref(x, gamma, eps, plan):
    """The kernel's plain model under a launch plan (``rmsnorm_plan``): only
    what the plan covers is written, every other element is NaN.  The rows
    kernel's order: each lane sums x² over its vectors (i = 32p + l + 32Wk,
    k ascending, elements in order) by fused multiply-adds, the warp's 32
    lanes add by the xor butterfly, the row's W warps in warp order; then
    (x · r) · γ with r = rsqrt(sum / D + eps) rounded once (the kernel's
    ``__frsqrt_rn``), each step rounded to float32, once to x's type.  A
    fused multiply-add, the division by D (which ATen on the card would
    take as a product with 1/D) and the correctly rounded rsqrt are taken
    in float64 and rounded once to float32, which gives the kernel's bits
    but where a float64 result lies on a float32 tie.  Runs on x's device.
    The block kernel's rows (W = 0) take :func:`rmsnorm_ref`."""
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.device
    xf = x.reshape(rows, d).float()
    out = torch.full((rows, d), float("nan"), device=dev)
    live = min(rows, plan.blocks * plan.rows_per_block)
    if plan.warps_per_row == 0:
        out[:live] = rmsnorm_ref(xf[:live], gamma.float(), eps)
        return out.to(x.dtype).reshape(x.shape)
    w, v, e = plan.warps_per_row, plan.vecs_per_lane, 16 // x.element_size()
    width = min(d, 32 * w * v * e)              # the elements the lanes hold
    held = torch.zeros((live, 32 * w * v * e), device=dev)
    held[:, :width] = xf[:live, :width]
    lanes = held.reshape(live, v, w, 32, e)     # [row, k, p, l, j]
    s = torch.zeros((live, w, 32), device=dev)
    for k in range(v):
        for j in range(e):
            f = lanes[:, k, :, :, j].double()
            s = (s.double() + f * f).float()     # fmaf(f, f, s)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, :, torch.arange(32, device=dev) ^ off]
    total = s[:, 0, 0]
    for p in range(1, w):
        total = total + s[:, p, 0]
    mean = (total.double() / d).float()
    r = torch.rsqrt((mean + eps).double()).float()[:, None]
    out[:live, :width] = (xf[:live, :width] * r) * gamma.float()[:width]
    return out.to(x.dtype).reshape(x.shape)
