"""pixtral-12b — VLM: mistral-nemo-style decoder; pixtral-ViT frontend is a
STUB (input_specs() supplies precomputed patch embeddings prepended to text).

[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072.  Attention inner dim = 32*128 = 4096 != d_model
(nemo-style narrow attention).
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv=8,
        d_ff=14336,
        vocab=131072,
        head_dim=128,
        rope_theta=1e6,
        n_img_tokens=1024,
        microbatch=16,
    )
