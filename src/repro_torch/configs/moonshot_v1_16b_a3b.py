"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
d_ff=1408 (per expert) vocab=163840.  64 % 16 == 0 -> expert parallelism over
the model axis with all-to-all dispatch.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=1408,
        vocab=163840,
        head_dim=128,
        n_experts=64,
        top_k=6,
        matmul_out_dtype="float32",
        microbatch=8,
    )
