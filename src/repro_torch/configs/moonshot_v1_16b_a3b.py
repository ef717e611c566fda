"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
(expert) vocab=163840, 64 experts top-6 — kimi/moonlight.
[hf:moonshotai/Moonlight-16B-A3B]

DeepSeek-V3-style: 2 shared experts, first layer dense (d_ff=11264).
"""
from .base import ArchConfig, AttnConfig, BlockSpec, MoEConfig, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                      rope_theta=50_000.0)
    moe = MoEConfig(n_experts=64, top_k=6, d_ff_expert=1_408, n_shared=2,
                    capacity_factor=1.25)
    dense0 = BlockSpec(kind="attn", attn=attn, d_ff=11_264, act="swiglu")
    moe_blk = BlockSpec(kind="attn", attn=attn, moe=moe, act="swiglu")
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        d_model=2_048,
        vocab_size=163_840,
        stages=(
            Stage(pattern=(dense0,), repeats=1),
            Stage(pattern=(moe_blk,), repeats=47),
        ),
        norm_eps=1e-5,
        sub_quadratic=False,   # full attention → long_500k skipped
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
