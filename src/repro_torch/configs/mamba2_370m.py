"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]"""
from .base import ArchConfig, BlockSpec, SSMConfig, Stage


def config() -> ArchConfig:
    ssm = SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                    conv_width=4, chunk=128)
    mb = BlockSpec(kind="mamba", ssm=ssm)
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        d_model=1_024,
        vocab_size=50_280,
        stages=(Stage(pattern=(mb,), repeats=48),),
        norm_eps=1e-5,
        sub_quadratic=True,    # SSM → long_500k runs
        source="arXiv:2405.21060",
    )
