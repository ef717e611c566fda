"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256. [arXiv:2403.08295]"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=16, n_kv_heads=16, head_dim=256,
                      rope_theta=10_000.0)
    block = BlockSpec(kind="attn", attn=attn, d_ff=24_576, act="geglu")
    return ArchConfig(
        name="gemma-7b",
        family="dense",
        d_model=3_072,
        vocab_size=256_000,
        stages=(Stage(pattern=(block,), repeats=28),),
        norm_eps=1e-6,
        sub_quadratic=False,   # full attention → long_500k skipped
        source="arXiv:2403.08295",
    )
