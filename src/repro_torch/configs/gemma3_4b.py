"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

34 layers = 5 × (5 local + 1 global) + 4 local tail.
"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage

_LOCAL_WINDOW = 1_024


def config() -> ArchConfig:
    local = AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                       window=_LOCAL_WINDOW, rope_theta=10_000.0)
    glob = AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                      rope_theta=1_000_000.0)
    lb = BlockSpec(kind="attn", attn=local, d_ff=10_240, act="geglu")
    gb = BlockSpec(kind="attn", attn=glob, d_ff=10_240, act="geglu")
    return ArchConfig(
        name="gemma3-4b",
        family="dense",
        d_model=2_560,
        vocab_size=262_144,
        stages=(
            Stage(pattern=(lb, lb, lb, lb, lb, gb), repeats=5),
            Stage(pattern=(lb,), repeats=4),
        ),
        norm_eps=1e-6,
        sub_quadratic=True,    # 5:1 local:global → long_500k runs
        source="hf:google/gemma-3-4b-pt (pattern); unverified",
    )
