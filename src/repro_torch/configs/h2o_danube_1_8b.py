"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention. [arXiv:2401.16818]"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=32, n_kv_heads=8, head_dim=80,
                      window=4_096, rope_theta=10_000.0)
    block = BlockSpec(kind="attn", attn=attn, d_ff=6_912, act="swiglu")
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        d_model=2_560,
        vocab_size=32_000,
        stages=(Stage(pattern=(block,), repeats=24),),
        norm_eps=1e-5,
        sub_quadratic=True,    # SWA → long_500k runs
        source="arXiv:2401.16818",
    )
