"""moonshot-v1-16b-a3b — the reference's MoE stand-in: 48 layers of plain
16-head attention (head 128) and 64 experts of 1408, top-6 under softmax
routing, no shared experts, no leading dense layer, tied embeddings.

It is not the published Moonlight-16B-A3B (27 layers of latent attention,
sigmoid routing with shared experts, a leading dense layer, an untied
head): that model is ``moonlight_16b_a3b.py``.  This copy keeps the
reference's values field for field (the parity tests hold them).  64 % 16
== 0 -> expert parallelism over the model axis with all-to-all dispatch.
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
