"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (kv=128) d_ff=1536(expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 160 routed experts top-6.
[arXiv:2405.04434]

Layer 0 uses a dense FFN (paper: first layer dense, d_ff=12288); layers
1–59 are MoE.  MLA dims: q_lora=1536, qk_nope=128, qk_rope=64, v=128.
"""
from .base import ArchConfig, AttnConfig, BlockSpec, MoEConfig, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=128, n_kv_heads=128, head_dim=128,
                      kv_lora=512, q_lora=1_536, rope_head_dim=64,
                      v_head_dim=128, rope_theta=10_000.0)
    moe = MoEConfig(n_experts=160, top_k=6, d_ff_expert=1_536, n_shared=2,
                    capacity_factor=1.25)
    dense0 = BlockSpec(kind="attn", attn=attn, d_ff=12_288, act="swiglu")
    moe_blk = BlockSpec(kind="attn", attn=attn, moe=moe, act="swiglu")
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        d_model=5_120,
        vocab_size=102_400,
        stages=(
            Stage(pattern=(dense0,), repeats=1),
            Stage(pattern=(moe_blk,), repeats=59),
        ),
        norm_eps=1e-6,
        sub_quadratic=False,   # full (MLA) attention → long_500k skipped
        source="arXiv:2405.04434",
    )
