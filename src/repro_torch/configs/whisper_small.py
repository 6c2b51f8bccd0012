"""whisper-small — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs() supplies precomputed frame embeddings).

[arXiv:2212.04356; unverified]  12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  n_layers = decoder depth; encoder depth equal.  GELU MLP,
sinusoidal/learned positions (no RoPE).  Decoder target length capped at 448
(whisper's max); decode_32k attends over a 32k-frame encoder memory.
"""
from repro_torch.configs.base import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv=12,
        d_ff=3072,
        vocab=51865,
        head_dim=64,
        mlp_type="gelu",
        dec_len=448,
        tie_embeddings=True,
        microbatch=8,
    )
