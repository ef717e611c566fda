"""Public SMMM: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .ref import smmm_bell_ref
from .spmm import smmm_hopper, smmm_problem


def smmm(values, indices, b):
    """Blocked-ELL sparse(A) @ dense(B), float32 accumulation, in b's type.

    ``values``/``indices`` come from :func:`.ref.dense_to_bell`."""
    if all(t.device.type == "cpu" for t in (values, indices, b)):
        _cuda.require(smmm_problem(values, indices, b), "SMMM")
        return smmm_bell_ref(values, indices, b)
    return smmm_hopper(values, indices, b)


def smmm_supported(values, indices, b, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return smmm_problem(values, indices, b) is None
