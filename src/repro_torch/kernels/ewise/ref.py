"""Plain PyTorch oracles for the element-wise binary aliases (EWMM / EWMD /
EWADD / EWSUB) — port of ``repro.kernels.ewise.ref`` — and the kernel's
plain model under a launch plan."""
import torch

from .ewise import THREADS


def ewmm_ref(a, b):
    return a * b


def ewmd_ref(a, b):
    return a / b


def ewadd_ref(a, b):
    return a + b


def ewsub_ref(a, b):
    return a - b


#: the library rows: one ATen call each
ewmm_aten, ewmd_aten, ewadd_aten, ewsub_aten = torch.mul, torch.div, torch.add, torch.sub

#: op name -> oracle, and op name -> library call
OP_REFS = {"mul": ewmm_ref, "div": ewmd_ref, "add": ewadd_ref, "sub": ewsub_ref}
OP_ATEN = {"mul": ewmm_aten, "div": ewmd_aten, "add": ewadd_aten, "sub": ewsub_aten}


def ewise_plan_elements(n: int, plan, device=None) -> torch.Tensor:
    """The flat index of every element the kernel writes under ``plan``
    (``ewise.ewise_plan``), once for each time it is written: thread t of
    block g takes items g·U·THREADS + u·THREADS + t below n // item_elems,
    each of item_elems elements, and the last block's first threads the n mod
    item_elems elements past them."""
    e, u, blocks = plan
    items = n // e

    def span(k):
        return torch.arange(k, device=device)

    item = (span(blocks)[:, None, None] * (u * THREADS) + span(u)[None, :, None] * THREADS
            + span(THREADS)[None, None, :]).reshape(-1)
    item = item[item < items]
    elems = (item[:, None] * e + span(e)).reshape(-1)
    tail = items * e + span(THREADS if blocks else 0)
    return torch.cat([elems, tail[tail < n]])


def ewise_plan_ref(a, b, op: str, plan):
    """The kernel's plain model under a launch plan: ``OP_REFS[op]`` on the
    elements :func:`ewise_plan_elements` covers, NaN on every other, in
    ``a``'s shape and type."""
    idx = ewise_plan_elements(a.numel(), plan, a.device)
    out = torch.full((a.numel(),), float("nan"), dtype=a.dtype, device=a.device)
    out[idx] = OP_REFS[op](a.reshape(-1)[idx], b.reshape(-1)[idx])
    return out.reshape(a.shape)
