"""mamba2-780m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536 d_ff=0 vocab=50280
ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv=0,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_headdim=64,
        sub_quadratic=True,
        microbatch=8,
    )
