"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (the summed codebook embeddings of the
delay-pattern interleave); the backbone is the plain transformer decoder.
"""
from .base import ArchConfig, AttnConfig, BlockSpec, Stage


def config() -> ArchConfig:
    attn = AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64,
                      rope_theta=10_000.0)
    block = BlockSpec(kind="attn", attn=attn, d_ff=8_192, act="gelu")
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        d_model=2_048,
        vocab_size=2_048,
        stages=(Stage(pattern=(block,), repeats=48),),
        frontend="frame_embed",
        norm_eps=1e-5,
        sub_quadratic=False,   # full attention → long_500k skipped
        source="arXiv:2306.05284",
    )
