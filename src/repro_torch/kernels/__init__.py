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
10) and ``hopper`` (kernel, 20; MMM's, EW*'s, RMSNORM's and SORT's with a
tuning space over their launch plans; none for SSD, SSD_DECODE, GQA_DECODE and
MOE_FFN, which have no Pallas site; EMBED_GRAD, the embedding's backward,
has no Pallas site either but keeps a kernel, for its fixed sum order;
LM_GRAD and ADAMW_STEP share one callable on all three) — so the runtime
agent resolves each alias
to the best feasible substrate (hopper > aten > torch by default), and
declares which aliases the graph fusion pass (DESIGN.md §12) may collapse
into chains.
"""
from __future__ import annotations

from ..core.registry import GLOBAL_REGISTRY, KernelAttributes, KernelRecord

_REGISTERED = False

_HOPPER_ATTRS = dict(vid="nvidia", pid="h100")
_ANY_ATTRS = dict(vid="*", pid="*")


def _rec(alias, fn, platform, prio, *, failsafe=False, supports=None,
         space=None, doc=""):
    hw = _HOPPER_ATTRS if platform == "hopper" else _ANY_ATTRS
    return KernelRecord(
        alias=alias, fn=fn, platform=platform, priority=prio,
        attrs=KernelAttributes(sw_fid=f"fid:{alias.lower()}", **hw),
        supports=supports, is_failsafe=failsafe, tuning_space=space, doc=doc)


def register_all(registry=None) -> None:
    """Idempotently publish all built-in kernels to the registry."""
    global _REGISTERED
    registry = registry or GLOBAL_REGISTRY
    if _REGISTERED and registry is GLOBAL_REGISTRY:
        return

    from .conv1d import conv1d, conv1d_ref
    from .embed_grad import embed_grad, embed_grad_ref
    from .embed_grad.ops import embed_grad_supported
    from .embed_grad.ref import embed_grad_aten
    from .conv1d.ops import conv1d_supported
    from .conv1d.ref import conv1d_aten
    from .ewise import (ewadd, ewadd_ref, ewmd, ewmd_ref, ewmm, ewmm_ref,
                        ewsub, ewsub_ref)
    from .ewise.ewise import ewise_space
    from .ewise.ops import ewise_supported
    from .ewise.ref import ewadd_aten, ewmd_aten, ewmm_aten, ewsub_aten
    from .fft import fft, fft_ref
    from .fft.ops import fft_supported
    from .fft.ref import fft_aten
    from .flash_attention import attention_ref, flash_attention
    from .flash_attention.ops import flash_attention_supported
    from .flash_attention.ref import attention_aten
    from .jacobi import jacobi_step, jacobi_step_ref
    from .jacobi.ops import jacobi_supported
    from .jacobi.ref import jacobi_step_aten
    from .matmul import mmm, mmm_ref
    from .matmul.matmul import mmm_space
    from .matmul.ops import mmm_supported
    from .matmul.ref import mmm_aten
    from .mvm import mvm, mvm_ref
    from .mvm.ops import mvm_supported
    from .mvm.ref import mvm_aten
    from .rmsnorm import rmsnorm, rmsnorm_ref
    from .rmsnorm.ops import rmsnorm_supported
    from .rmsnorm.rmsnorm import rmsnorm_space
    from .rmsnorm.ref import rmsnorm_aten
    from .sorthist import hist, hist_ref, sort, sort_ref
    from .sorthist.ops import hist_supported, sort_supported
    from .sorthist.sorthist import sort_space
    from .sorthist.ref import hist_aten, sort_aten
    from .spmm import smmm
    from .spmm.ops import smmm_supported
    from .spmm.ref import smmm_aten, smmm_bell_ref
    from .vdp import vdp, vdp_ref
    from .vdp.ops import vdp_supported
    from .vdp.ref import vdp_aten

    table = [
        # (alias, ref_fn, aten_fn, hopper_fn, hopper feasibility)
        ("MMM", mmm_ref, mmm_aten, mmm, mmm_supported),
        # unlike the reference's tiled Pallas rows, csrc/ewise.cu takes 0-d
        # operands (one element), so scalar residual reduces stay on hopper
        ("EWMM", ewmm_ref, ewmm_aten, ewmm, ewise_supported),
        ("EWMD", ewmd_ref, ewmd_aten, ewmd, ewise_supported),
        ("EWADD", ewadd_ref, ewadd_aten, ewadd, ewise_supported),
        ("EWSUB", ewsub_ref, ewsub_aten, ewsub, ewise_supported),
        ("MVM", mvm_ref, mvm_aten, mvm, mvm_supported),
        ("VDP", vdp_ref, vdp_aten, vdp, vdp_supported),
        ("JS", jacobi_step_ref, jacobi_step_aten, jacobi_step, jacobi_supported),
        ("1DCONV", conv1d_ref, conv1d_aten, conv1d, conv1d_supported),
        # SMMM's oracle reads the blocked-ELL parts slot by slot
        ("SMMM", smmm_bell_ref, smmm_aten, smmm, smmm_supported),
        # data-reorganization and spectral class (paper Table II rows 9-11)
        ("FFT", fft_ref, fft_aten, fft, fft_supported),
        ("SORT", sort_ref, sort_aten, sort, sort_supported),
        ("HIST", hist_ref, hist_aten, hist, hist_supported),
        # the model path (models/): normalization and sequence attention
        ("RMSNORM", rmsnorm_ref, rmsnorm_aten, rmsnorm, rmsnorm_supported),
        ("FLASH_ATTN", attention_ref, attention_aten, flash_attention,
         flash_attention_supported),
        # the embedding's backward: no Pallas site (the reference's is XLA's
        # scatter-add); its kernel adds in a fixed order, so training's
        # gradients repeat bit for bit on the card (csrc/embed_grad.cu)
        ("EMBED_GRAD", embed_grad_ref, embed_grad_aten, embed_grad,
         embed_grad_supported),
    ]
    # the hopper rows whose kernels take their launch plan at run time
    # declare a tuning space (DESIGN.md §9); the torch and aten rows never do
    spaces = {"MMM": mmm_space, "EWMM": ewise_space, "EWMD": ewise_space,
              "EWADD": ewise_space, "EWSUB": ewise_space,
              "RMSNORM": rmsnorm_space, "SORT": sort_space}
    for alias, ref_fn, aten_fn, hopper_fn, ok in table:
        registry.register(_rec(alias, ref_fn, "torch", 0, failsafe=True))
        registry.register(_rec(alias, aten_fn, "aten", 10))
        registry.register(_rec(alias, hopper_fn, "hopper", 20, supports=ok,
                               space=spaces.get(alias)))

    # Sequence-model aliases with no Pallas site in the reference, so no
    # hopper row: SSD's scan is the fail-safe and its chunked form (batched
    # float32 products) the library row; SSD_DECODE's step serves both.
    # MOE_FFN: the oracle in the input type, the library row's float32
    # products.  GQA_DECODE (decode-time attention) is attention_ref under
    # both rows; the model attends inline at decode and dispatches it
    # nowhere, as in the reference.
    from .moe_ffn import grouped_ffn, grouped_ffn_ref
    from .ssd import ssd_chunked, ssd_decode_step, ssd_ref

    def gqa_decode(q, k, v, **kw):
        return attention_ref(q, k, v, causal=True, **kw)

    for alias, ref_fn, aten_fn in (("SSD", ssd_ref, ssd_chunked),
                                   ("SSD_DECODE", ssd_decode_step, ssd_decode_step),
                                   ("MOE_FFN", grouped_ffn_ref, grouped_ffn),
                                   ("GQA_DECODE", gqa_decode, gqa_decode)):
        registry.register(_rec(alias, ref_fn, "torch", 0, failsafe=True))
        registry.register(_rec(alias, aten_fn, "aten", 10))

    # Data-movement builtins (DESIGN.md §10): every substrate carries a row,
    # so a graph can stage a value on whichever agent runs its consumer.
    # No TPU kernel stands behind them: their rows are ATen calls.
    from .staging import concat_ref, copy_ref, copy_stage
    registry.register(_rec("COPY", copy_ref, "torch", 0, failsafe=True))
    registry.register(_rec("COPY", copy_stage, "aten", 10))
    registry.register(_rec("COPY", copy_stage, "hopper", 20))
    registry.register(_rec("CONCAT", concat_ref, "torch", 0, failsafe=True))
    registry.register(_rec("CONCAT", concat_ref, "aten", 10))
    registry.register(_rec("CONCAT", concat_ref, "hopper", 20))

    # Training-step builtins (DESIGN.md §15): the forward/backward and the
    # optimizer update as aliases, so device-group members (the trainer's
    # comm mode) can dispatch them.  Every platform row shares ONE callable, as in the
    # reference; the callables run the model's own dispatches (MMM, RMSNORM,
    # FLASH_ATTN) in the caller's thread, so autograd sees them.
    from ..train.step_kernels import adamw_step_vec, lm_grad_vec
    for alias, fn in (("LM_GRAD", lm_grad_vec), ("ADAMW_STEP", adamw_step_vec)):
        registry.register(_rec(alias, fn, "torch", 0, failsafe=True))
        registry.register(_rec(alias, fn, "aten", 10))
        registry.register(_rec(alias, fn, "hopper", 20))

    # Fusibility rules (DESIGN.md §12): EW* members carry the element-wise
    # op the chain kernel (csrc/fused.cu) applies; COPY is a unary
    # pass-through; RMSNORM/MVM/JS fuse as a call loop; MMM may only end a
    # chain.  Rules are global (alias semantics, not registry state).
    from ..core.fusion import register_fusible
    register_fusible("EWMM", ewise_op="mul")
    register_fusible("EWMD", ewise_op="div")
    register_fusible("EWADD", ewise_op="add")
    register_fusible("EWSUB", ewise_op="sub")
    register_fusible("COPY", unary=True)
    register_fusible("RMSNORM")
    register_fusible("MVM")
    register_fusible("JS")
    register_fusible("MMM", terminal=True)

    if registry is GLOBAL_REGISTRY:
        _REGISTERED = True
