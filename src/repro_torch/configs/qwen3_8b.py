"""qwen3-8b — dense GQA with qk-norm.

[hf:Qwen/Qwen3-8B; hf]  36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=12288,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        microbatch=16,
    )
