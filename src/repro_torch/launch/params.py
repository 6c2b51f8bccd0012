"""Analytic parameter / FLOP accounting per architecture (port of
``repro/launch/params.py``): the roofline's MODEL_FLOPS and the
useful-compute ratio.

Conventions (the reference's): MODEL_FLOPS counts matmul work only --
2·N_active per processed token forward (prefill and decode), 6·N_active
training (forward and backward) -- with N_active the parameters that
take part in a token's matmuls (moe: top_k of E experts; hybrid: the
weight-tied shared block counted once per *application*; the embedding
gather: zero; the tied unembed: counted once).  Attention score and value
products are left out (the classic 6ND convention), so ``useful_ratio`` < 1
even for a perfect schedule.  The audio family's encoder tokens and decoder
tokens see different stacks and are counted apart.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig

__all__ = ["param_counts", "active_param_count", "model_flops_total"]


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    return (d * cfg.n_heads * hd        # wq
            + 2 * d * cfg.n_kv * hd     # wk, wv
            + cfg.n_heads * hd * d)     # wo


def _mlp_params(cfg: ArchConfig, d_ff: int | None = None) -> int:
    ff = cfg.d_ff if d_ff is None else d_ff
    mult = 2 if cfg.mlp_type == "gelu" else 3
    return mult * cfg.d_model * ff


def _ssm_layer_params(cfg: ArchConfig) -> int:
    from repro_torch.models.transformer import ssm_dims

    dims = ssm_dims(cfg)
    return (cfg.d_model * dims.d_in_proj
            + dims.d_inner * cfg.d_model
            + dims.d_conv * dims.conv_dim)


def _encdec_stacks(cfg: ArchConfig) -> tuple[int, int]:
    enc = cfg.n_enc_layers * (_attn_params(cfg) + _mlp_params(cfg))
    dec = cfg.n_layers * (2 * _attn_params(cfg) + _mlp_params(cfg))
    return enc, dec


def param_counts(cfg: ArchConfig) -> dict[str, int]:
    """{"total": all stored params, "active": matmul params per token}."""
    d = cfg.d_model
    embed = cfg.vocab * d
    if cfg.family in ("dense", "vlm"):
        layer = _attn_params(cfg) + _mlp_params(cfg)
        total = active = cfg.n_layers * layer + embed  # tied unembed
    elif cfg.family == "moe":
        attn = _attn_params(cfg)
        expert = 3 * d * cfg.d_ff          # gated experts
        router = d * cfg.n_experts
        total = cfg.n_layers * (attn + router + cfg.n_experts * expert) \
            + embed
        active = cfg.n_layers * (attn + router + cfg.top_k * expert) + embed
    elif cfg.family == "ssm":
        total = active = cfg.n_layers * _ssm_layer_params(cfg) + embed
    elif cfg.family == "hybrid":
        mamba = cfg.n_layers * _ssm_layer_params(cfg)
        shared = (2 * d * d                 # concat in_proj
                  + _attn_params(cfg) + 3 * d * cfg.d_ff)
        n_apps = cfg.n_layers // cfg.attn_every
        total = mamba + shared + embed
        active = mamba + n_apps * shared + embed
    elif cfg.family == "audio":
        enc, dec = _encdec_stacks(cfg)
        total = active = enc + dec + embed
    else:
        raise ValueError(cfg.family)
    return {"total": int(total), "active": int(active)}


def active_param_count(cfg: ArchConfig) -> int:
    return param_counts(cfg)["active"]


def model_flops_total(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Matmul MODEL_FLOPS for one step of this cell (the whole mesh)."""
    B, S = shape.global_batch, shape.seq_len
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    if cfg.family == "audio":
        enc, dec = _encdec_stacks(cfg)
        embed = cfg.vocab * cfg.d_model
        if shape.kind == "decode":
            return mult * B * (dec + embed)
        return mult * B * (S * enc + cfg.dec_len * (dec + embed))
    tokens = B * (1 if shape.kind == "decode" else S)
    return mult * param_counts(cfg)["active"] * tokens
