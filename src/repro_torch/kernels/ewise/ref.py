"""Plain PyTorch oracles for the element-wise binary aliases (EWMM / EWMD /
EWADD / EWSUB) — port of ``repro.kernels.ewise.ref``."""
import torch


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
