"""moonlight-16b-a3b — DeepSeek-V3-style MoE with latent attention (MLA).

[hf:moonshotai/Moonlight-16B-A3B; config.json, model_type deepseek_v3]
27L d_model=2048 16H, q/k head 192 (128 nope + 64 rope), v head 128,
kv_lora_rank 512, no q LoRA, rope_theta 5e4; layer 0 a dense SwiGLU of
11264, layers 1-26 64 routed experts of 1408 (top-6, sigmoid scores with a
correction bias, normalised gates x 2.446) and 2 shared experts; vocab
163840, untied lm_head, RMSNorm eps 1e-5.  The port's own configuration:
the reference has none (its ``moonshot-v1-16b-a3b`` is a different, plain
attention stand-in).
"""
from repro_torch.configs.base import MlaMoeConfig


def get_config() -> MlaMoeConfig:
    return MlaMoeConfig(
        name="moonlight-16b-a3b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=1408,
        vocab=163840,
        head_dim=192,
        rope_theta=5e4,
        n_experts=64,
        top_k=6,
        tie_embeddings=False,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        first_dense=1,
        dense_d_ff=11264,
        n_shared=2,
        routed_scale=2.446,
    )
