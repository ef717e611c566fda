"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block.
[arXiv:2411.15242]

Adaptation: the single shared attention+FFN block (one weight copy) is
invoked after every 6 Mamba2 layers — 38 layers ≈ 6 × (6 mamba + shared) + 2
mamba tail; the shared block's parameters live outside the scanned stacks.
"""
from .base import ArchConfig, AttnConfig, BlockSpec, SSMConfig, Stage


def config() -> ArchConfig:
    ssm = SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                    conv_width=4, chunk=128)
    mb = BlockSpec(kind="mamba", ssm=ssm)
    sb = BlockSpec(kind="shared_attn")
    shared_attn = AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64,
                             rope_theta=10_000.0)
    return ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        d_model=2_048,
        vocab_size=32_000,
        stages=(
            Stage(pattern=(mb, mb, mb, mb, mb, mb, sb), repeats=6),
            Stage(pattern=(mb,), repeats=2),
        ),
        shared_attn=shared_attn,
        shared_d_ff=8_192,
        norm_eps=1e-5,
        sub_quadratic=True,    # hybrid SSM → long_500k runs
        source="arXiv:2411.15242",
    )
