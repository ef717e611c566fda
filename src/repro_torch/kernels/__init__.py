"""HME region: multi-source kernel repository (paper §V-A4) — port of
``repro.kernels``.

Each subpackage ships three artifacts per kernel:
  * ``<name>.py`` — the ctypes wrapper around the hand-written Hopper kernel
    (``csrc/<name>.cu``), with its launch counter,
  * ``ops.py``    — the public function (kernel on CUDA tensors, plain
    version on CPU tensors),
  * ``ref.py``    — the plain PyTorch oracle (the C2MPI fail-safe) and the
    library (ATen) call.

:func:`register_all` publishes three rows per alias with Table-II
attributes — ``torch`` (oracle, priority 0, fail-safe), ``aten`` (library,
10) and ``hopper`` (kernel, 20) — so the runtime agent resolves each alias
to the best feasible substrate (hopper > aten > torch by default).
"""
from __future__ import annotations

from ..core.registry import GLOBAL_REGISTRY, KernelAttributes, KernelRecord

_REGISTERED = False

_HOPPER_ATTRS = dict(vid="nvidia", pid="h100")
_ANY_ATTRS = dict(vid="*", pid="*")


def _ewise_ok(supported):
    """EW* hopper feasibility: 0-d operands (e.g. scalar residual reduces)
    go to the aten/torch rows, as in the reference."""
    def ok(*args, **kw) -> bool:
        return all(getattr(a, "ndim", 0) >= 1 for a in args) and supported(*args)
    return ok


def _rec(alias, fn, platform, prio, *, failsafe=False, supports=None, doc=""):
    hw = _HOPPER_ATTRS if platform == "hopper" else _ANY_ATTRS
    return KernelRecord(
        alias=alias, fn=fn, platform=platform, priority=prio,
        attrs=KernelAttributes(sw_fid=f"fid:{alias.lower()}", **hw),
        supports=supports, is_failsafe=failsafe, doc=doc)


def register_all(registry=None) -> None:
    """Idempotently publish all built-in kernels to the registry."""
    global _REGISTERED
    registry = registry or GLOBAL_REGISTRY
    if _REGISTERED and registry is GLOBAL_REGISTRY:
        return

    from .ewise import (ewadd, ewadd_ref, ewmd, ewmd_ref, ewmm, ewmm_ref,
                        ewsub, ewsub_ref)
    from .ewise.ops import ewise_supported
    from .ewise.ref import ewadd_aten, ewmd_aten, ewmm_aten, ewsub_aten
    from .matmul import mmm, mmm_ref
    from .matmul.ops import mmm_supported
    from .matmul.ref import mmm_aten
    from .mvm import mvm, mvm_ref
    from .mvm.ops import mvm_supported
    from .mvm.ref import mvm_aten
    from .vdp import vdp, vdp_ref
    from .vdp.ops import vdp_supported
    from .vdp.ref import vdp_aten

    ew_ok = _ewise_ok(ewise_supported)
    table = [
        # (alias, ref_fn, aten_fn, hopper_fn, hopper feasibility)
        ("MMM", mmm_ref, mmm_aten, mmm, mmm_supported),
        ("EWMM", ewmm_ref, ewmm_aten, ewmm, ew_ok),
        ("EWMD", ewmd_ref, ewmd_aten, ewmd, ew_ok),
        ("EWADD", ewadd_ref, ewadd_aten, ewadd, ew_ok),
        ("EWSUB", ewsub_ref, ewsub_aten, ewsub, ew_ok),
        ("MVM", mvm_ref, mvm_aten, mvm, mvm_supported),
        ("VDP", vdp_ref, vdp_aten, vdp, vdp_supported),
    ]
    for alias, ref_fn, aten_fn, hopper_fn, ok in table:
        registry.register(_rec(alias, ref_fn, "torch", 0, failsafe=True))
        registry.register(_rec(alias, aten_fn, "aten", 10))
        registry.register(_rec(alias, hopper_fn, "hopper", 20, supports=ok))

    if registry is GLOBAL_REGISTRY:
        _REGISTERED = True
