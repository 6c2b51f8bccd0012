"""phi3-medium-14b — dense RoPE + SwiGLU + GQA.

[arXiv:2404.14219; unverified]  40L d_model=5120 40H (kv=10) d_ff=17920
vocab=100352.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv=10,
        d_ff=17920,
        vocab=100352,
        head_dim=128,
        microbatch=16,
    )
