"""grok-1-314b — MoE, 8 experts top-2.

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (kv=8) d_ff=32768
vocab=131072.  8 experts < 16-way model axis -> experts replicated, TP inside
each expert (d_ff sharded); see parallel/sharding.py fallback.
bf16 optimizer moments: 314B params' f32 moments would not fit 16 GiB/chip.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        d_ff=32768,
        vocab=131072,
        head_dim=128,
        n_experts=8,
        top_k=2,
        opt_state_dtype="bfloat16",
        param_dtype="bfloat16",
        grad_accum_dtype="bfloat16",
        matmul_out_dtype="float32",
        microbatch=32,
    )
