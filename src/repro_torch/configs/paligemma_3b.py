"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216 — SigLIP frontend + gemma decoder. [arXiv:2407.07726]

The SigLIP vision tower is a STUB per the assignment: ``input_specs()``
provides 256 precomputed patch embeddings per image, prepended as a
bidirectional prefix (prefix-LM attention).
"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage

N_PATCHES = 256


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                      rope_theta=10_000.0)
    block = BlockSpec(kind="attn", attn=attn, d_ff=16_384, act="geglu")
    return ArchConfig(
        name="paligemma-3b",
        family="vlm",
        d_model=2_048,
        vocab_size=257_216,
        stages=(Stage(pattern=(block,), repeats=18),),
        frontend="patch_embed",
        prefix_len=N_PATCHES,
        norm_eps=1e-6,
        sub_quadratic=False,   # full attention → long_500k skipped
        source="arXiv:2407.07726",
    )
