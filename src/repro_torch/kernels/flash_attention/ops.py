"""Public FLASH_ATTN: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors."""
from __future__ import annotations

from .. import _cuda
from .flash_attention import flash_attention_hopper, flash_attention_problem
from .ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    prefix_len: int = 0):
    """Online-softmax GQA attention, q (B,H,Sq,D), k/v (B,Hkv,Skv,D): the
    causal, sliding-window and prefix-LM masks of the reference, query i at
    position Skv − Sq + i, scale D^-1/2.

    CPU tensors take the plain version (:func:`attention_ref`); CUDA tensors
    launch the hand-written kernel or raise — there is no fallback."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        _cuda.require(flash_attention_problem(q, k, v), "FLASH_ATTN")
        return attention_ref(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len)
    return flash_attention_hopper(q, k, v, causal=causal, window=window,
                                  prefix_len=prefix_len)


def flash_attention_supported(q, k, v, **kw) -> bool:
    """Feasibility of the hopper row: the kernel takes these operands."""
    return flash_attention_problem(q, k, v) is None
