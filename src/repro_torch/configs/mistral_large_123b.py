"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=96, n_kv_heads=8, head_dim=128,
                      rope_theta=1_000_000.0)
    block = BlockSpec(kind="attn", attn=attn, d_ff=28_672, act="swiglu")
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        d_model=12_288,
        vocab_size=32_768,
        stages=(Stage(pattern=(block,), repeats=88),),
        norm_eps=1e-5,
        sub_quadratic=False,   # pure full attention → long_500k skipped
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
