"""Decoder-only LM, dense family: init, prefill and paged decode.

Port of the dense-family paths of ``repro/models/transformer.py``.  The
reference's ``lax.scan`` over stacked layer parameters becomes a Python
loop over a list of per-layer parameter dicts.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       rmsnorm)
from repro_torch.numerics import kv_pages as kvp

__all__ = ["init_lm", "lm_prefill", "lm_decode_paged"]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.mlp_type != "swiglu":
        raise ValueError(f"the port serves the dense swiglu family, not "
                         f"{cfg.family!r}/{cfg.mlp_type!r}")


def _init_layer(gen: torch.Generator, cfg: ArchConfig,
                device) -> dict[str, Any]:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, device),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.hd,
                                        qk_norm=cfg.qk_norm, device=device),
        "mlp_norm": init_rmsnorm(cfg.d_model, device),
        "mlp": mlp_mod.init_swiglu(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_lm(gen: torch.Generator, cfg: ArchConfig, *, device="cuda",
            prepare_layer: Callable[[dict], dict] | None = None
            ) -> dict[str, Any]:
    """Random parameters, made layer by layer on ``device``.

    ``prepare_layer`` (the residue-resident pass) runs on each layer right
    after it is made, so only one layer's float weights exist at a time.
    """
    _check_family(cfg)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        "layers": [],
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    for _ in range(cfg.n_layers):
        layer = _init_layer(gen, cfg, device)
        params["layers"].append(layer if prepare_layer is None
                                else prepare_layer(layer))
    return params


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            dense_kw: dict[str, Any]) -> torch.Tensor:
    """Tied-embedding logits in the compute dtype.  Under ``rns`` and
    ``sdrns`` they run through the resident ``embed.logits_w`` planes like
    every other weight."""
    x = rmsnorm(params["final_norm"], x)
    system = dense_kw.get("system", "bns")
    if system in ("rns", "sdrns"):
        w = params["embed"].get("logits_w")
        if w is None:
            raise ValueError(f"system={system!r} needs the resident logits "
                             "weight embed.logits_w (Model.prepare_params)")
        return linear.dense({"w": w}, x, **dense_kw).to(x.dtype)
    return torch.matmul(x, params["embed"]["table"].to(x.dtype).T)


def _mlp_block(lp, x, dense_kw):
    return mlp_mod.swiglu(lp["mlp"], rmsnorm(lp["mlp_norm"], x), dense_kw)


def lm_prefill(params, cfg: ArchConfig, tokens: torch.Tensor, *,
               s_max: int | None = None, dense_kw=None,
               cache_dtype=torch.bfloat16, logits_at=None):
    """Process the prompt; return ``(logits (B, vocab), (k, v))`` with the
    KV cache stacked over layers, ``(L, B, s_max, Kv, hd)`` each.

    ``logits_at``: optional (B,) positions to read logits from instead of
    the last row.
    """
    _check_family(cfg)
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    B, S = tokens.shape
    s_max = S if s_max is None else s_max
    shape = (cfg.n_layers, B, s_max, cfg.n_kv, cfg.hd)
    k_cache = torch.empty(shape, dtype=cache_dtype, device=x.device)
    v_cache = torch.empty(shape, dtype=cache_dtype, device=x.device)
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
               qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
               dense_kw=dense_kw, cache_dtype=cache_dtype)
    for i, lp in enumerate(params["layers"]):
        h, (kc, vc) = attn_mod.prefill_attention(
            lp["attn"], rmsnorm(lp["attn_norm"], x), s_max, **akw)
        k_cache[i], v_cache[i] = kc, vc
        x = x + h
        x = x + _mlp_block(lp, x, dense_kw)
    if logits_at is not None:
        rows = torch.as_tensor(logits_at, device=x.device).long()
        xg = x[torch.arange(B, device=x.device), rows][:, None]
    else:
        xg = x[:, -1:]
    return _logits(params, cfg, xg, dense_kw)[:, 0], (k_cache, v_cache)


def lm_decode_paged(params, cfg: ArchConfig, token: torch.Tensor,
                    kv: "kvp.PagedKV", block_tab: torch.Tensor,
                    pos: torch.Tensor, *, page_size: int, dense_kw=None,
                    cache_dtype=torch.bfloat16, with_syndrome=False):
    """One decode step against the paged pool (updated in place).

    token: (B, 1) int; pos: (B,) int32 per-slot positions.  Returns
    ``(logits (B, vocab), kv)``; with ``with_syndrome=True`` (rns8r pools)
    also the per-(slot, layer) in-kernel syndrome map ``(B, L)`` int32,
    which stays on the device.
    """
    _check_family(cfg)
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], token, cd)
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
               qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
               dense_kw=dense_kw, cache_dtype=cache_dtype,
               with_syndrome=with_syndrome)
    syns = []
    for i, lp in enumerate(params["layers"]):
        lay = kvp.layer_slice(kv, i)
        att = attn_mod.paged_decode_attention(
            lp["attn"], rmsnorm(lp["attn_norm"], x), lay, block_tab, pos,
            page_size=page_size, **akw)
        if with_syndrome:
            h, lay, syn = att
            syns.append(syn)
        else:
            h, lay = att
        kv = kvp.layer_update(kv, i, lay)
        x = x + h
        x = x + _mlp_block(lp, x, dense_kw)
    logits = _logits(params, cfg, x, dense_kw)[:, 0]
    if with_syndrome:
        return logits, kv, torch.stack(syns, dim=1)
    return logits, kv
