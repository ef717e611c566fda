"""Architecture/config schema for all assigned model families — port of
``repro.configs.base``, field for field; only :meth:`ArchConfig.activation_dtype`
differs, returning a ``torch.dtype``.

The schema composes per-layer *stages*: a stage is a (block pattern, repeat
count) pair whose parameters are stacked and scanned — heterogeneous layer
patterns (gemma3's 5 local:1 global, zamba2's shared-attention interleave,
deepseek's dense-first-layer) become short stage lists with homogeneous
scan bodies, keeping the lowered HLO small at 60–88 layers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: Optional[int] = None          # sliding-window size (SWA)
    rope_theta: float = 10_000.0
    # MLA (DeepSeek-V2): latent-compressed KV
    kv_lora: int = 0                      # 0 = standard GQA
    q_lora: int = 0
    rope_head_dim: int = 0                # decoupled RoPE dims (MLA)
    v_head_dim: int = 0                   # MLA value head dim
    logit_softcap: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                     # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # expert-parallel dispatch wire format: "bf16" (exact) or "int8"
    # (per-token absmax quantization, DeepSeek-V3-style — halves a2a bytes)
    a2a_precision: str = "bf16"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int                        # N
    head_dim: int = 64                    # P
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer 'flavor' inside a stage pattern."""
    kind: str                             # "attn" | "mamba" | "shared_attn"
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None       # None = dense FFN
    ssm: Optional[SSMConfig] = None       # for kind == "mamba"
    d_ff: int = 0                         # dense FFN hidden (0 = no FFN)
    act: str = "swiglu"                   # swiglu | geglu | gelu


@dataclasses.dataclass(frozen=True)
class Stage:
    """``repeats`` × ``pattern`` (pattern unrolled inside the scan body)."""
    pattern: Tuple[BlockSpec, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                           # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False          # kept False (sharding; DESIGN.md §5)
    # frontends (vlm/audio): embeddings are provided by the stub
    frontend: str = "none"                # none | patch_embed | frame_embed
    prefix_len: int = 0                   # bidirectional prefix (vlm prefix-LM)
    # zamba2-style shared block: one weight copy referenced by stages
    shared_attn: Optional[AttnConfig] = None
    shared_d_ff: int = 0
    sub_quadratic: bool = False           # eligible for long_500k
    source: str = ""

    @property
    def n_layers(self) -> int:
        """Parameterized layers; shared-block *invocations* (zamba2) reuse
        one weight copy and do not add layers."""
        return sum(
            s.repeats * len([b for b in s.pattern if b.kind != "shared_attn"])
            for s in self.stages)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 128 so the unembed V dim shards over tp; logits
        in the padded tail are masked to -inf (exact loss)."""
        return -(-self.vocab_size // 128) * 128

    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink_attn(a: Optional[AttnConfig]):
            if a is None:
                return None
            heads = min(a.n_heads, 4)
            kv = max(1, min(a.n_kv_heads, heads))
            while heads % kv:
                kv -= 1
            return dataclasses.replace(
                a, n_heads=heads, n_kv_heads=kv, head_dim=32,
                window=min(a.window, 32) if a.window else None,
                kv_lora=32 if a.kv_lora else 0,
                q_lora=32 if a.q_lora else 0,
                rope_head_dim=16 if a.rope_head_dim else 0,
                v_head_dim=32 if a.v_head_dim else 0)

        def shrink_block(b: BlockSpec):
            moe = None
            if b.moe is not None:
                moe = dataclasses.replace(
                    b.moe, n_experts=min(8, b.moe.n_experts),
                    top_k=min(2, b.moe.top_k), d_ff_expert=32,
                    n_shared=min(1, b.moe.n_shared))
            ssm = None
            if b.ssm is not None:
                ssm = dataclasses.replace(b.ssm, state_dim=16, head_dim=16,
                                          chunk=16)
            return dataclasses.replace(
                b, attn=shrink_attn(b.attn), moe=moe, ssm=ssm,
                d_ff=64 if b.d_ff else 0)

        stages = tuple(
            Stage(pattern=tuple(shrink_block(b) for b in s.pattern),
                  repeats=min(2, s.repeats))
            for s in self.stages)
        return dataclasses.replace(
            self, d_model=64, vocab_size=256, stages=stages,
            shared_attn=shrink_attn(self.shared_attn),
            shared_d_ff=64 if self.shared_d_ff else 0,
            prefix_len=min(self.prefix_len, 8),
            dtype="float32")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                             # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def ssm_heads(cfg_d_model: int, ssm: SSMConfig) -> int:
    return cfg_d_model * ssm.expand // ssm.head_dim
