"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000 ssm_state=64.  The shared transformer block (attention + SwiGLU)
is applied after every 6th mamba layer on concat(hidden, embeddings) — see
models/transformer.py's hybrid path.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv=32,
        d_ff=14336,
        vocab=32000,
        head_dim=112,
        ssm_state=64,
        ssm_headdim=64,
        attn_every=6,
        sub_quadratic=True,
        microbatch=16,
    )
