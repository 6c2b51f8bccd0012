"""Whisper-style encoder-decoder: the audio family (port of
models/encdec.py).

The conv / log-mel front end is not part of the system: the encoder takes
precomputed frame embeddings ``(B, S_enc, d_model)`` (``frontends.py``).
Positions are sinusoidal embeddings added to the input, no RoPE.  Encoder
layers: non-causal self-attention and a GELU MLP.  Decoder layers: causal
self-attention, cross-attention over the encoder memory, a GELU MLP.  The
logits are the tied embedding table in float, as in the reference (its
``prepare_params`` makes no resident logits weight for this family).

Caches (stacked over the decoder layers on axis 0, updated in place by
decode):

* ``self``: ``KVCache`` over decoder positions, ``(L, B, dec_len, Kv, hd)``;
* ``cross``: each layer's projected encoder K/V, ``(L, B, S_enc, Kv, hd)``,
  computed once at prefill.

:func:`encdec_forward` is the teacher-forced training forward: no cache,
attention on materialized scores (``attention.core``; the kernels define
no backward), the reference's per-layer remat.

Kernels: the encoder's attention runs on the flash kernel (B2) with
``causal=False``; the cross-attention on B2 (non-causal, the decoder
prompt's rows against S_enc keys) at prefill and on the dense-cache decode
(B5, ``kv_len = S_enc``) at decode; the decoder's self-attention on B2 at
prefill and B5 over the self cache at decode.  The reference computes the
encoder's and the cross-attention with its materialized-score path (the
same function); the kernels keep the (B, H, Sq, S_enc) scores out of
memory.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       remat_call, rmsnorm,
                                       sinusoidal_positions)
from repro_torch.numerics import attention as nxattn

__all__ = ["init_encdec", "init_encdec_cache", "encdec_forward",
           "encdec_prefill", "encdec_decode"]


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig,
                    device) -> dict[str, Any]:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, device),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.hd, device=device),
        "mlp_norm": init_rmsnorm(cfg.d_model, device),
        "mlp": mlp_mod.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ArchConfig,
                    device) -> dict[str, Any]:
    return {
        "self_norm": init_rmsnorm(cfg.d_model, device),
        "self_attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                             cfg.n_kv, cfg.hd, device=device),
        "cross_norm": init_rmsnorm(cfg.d_model, device),
        "cross_attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                              cfg.n_kv, cfg.hd,
                                              device=device),
        "mlp_norm": init_rmsnorm(cfg.d_model, device),
        "mlp": mlp_mod.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig, *, device="cuda",
                prepare_layer: Callable[[dict], dict] | None = None
                ) -> dict[str, Any]:
    """Random parameters, made layer by layer (``prepare_layer`` runs on
    each right after it is made, as in ``transformer.init_lm``)."""
    prep = prepare_layer or (lambda p: p)
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        "enc_layers": [prep(_init_enc_layer(gen, cfg, device))
                       for _ in range(cfg.n_enc_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, device),
        "dec_layers": [prep(_init_dec_layer(gen, cfg, device))
                       for _ in range(cfg.n_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }


def init_encdec_cache(cfg: ArchConfig, batch: int, s_enc: int,
                      dtype=torch.bfloat16, device="cuda"):
    L = cfg.n_layers

    def kv(t):
        shape = (L, batch, t, cfg.n_kv, cfg.hd)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    return {"self": kv(cfg.dec_len), "cross": kv(s_enc)}


def _attn_kw(cfg: ArchConfig, dense_kw):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                dense_kw=dense_kw, apply_rope=False)


def _enc_layer(lp, x, cfg: ArchConfig, dense_kw, flash: bool = True):
    x = x + attn_mod.attention(lp["attn"], rmsnorm(lp["attn_norm"], x),
                               causal=False, flash=flash,
                               **_attn_kw(cfg, dense_kw))
    return x + mlp_mod.gelu_mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x),
                                dense_kw)


def _encode(params, cfg: ArchConfig, frames: torch.Tensor, dense_kw,
            train: bool = False):
    """The encoder memory; ``train``: materialized attention, remat."""
    cd = getattr(torch, cfg.compute_dtype)
    S = frames.shape[1]
    x = frames.to(cd) + sinusoidal_positions(
        S, cfg.d_model, device=frames.device).to(cd)[None]
    for lp in params["enc_layers"]:
        x = remat_call(train and cfg.remat, _enc_layer, lp, x, cfg,
                       dense_kw, not train)
    return rmsnorm(params["enc_norm"], x)


def _cross_kv(lp, memory, cfg: ArchConfig, dense_kw):
    B, T, _ = memory.shape
    k = linear.dense(lp["cross_attn"]["wk"], memory,
                     **dense_kw).reshape(B, T, cfg.n_kv, cfg.hd)
    v = linear.dense(lp["cross_attn"]["wv"], memory,
                     **dense_kw).reshape(B, T, cfg.n_kv, cfg.hd)
    return k, v


def _cross_attend(lp, x, k, v, cfg: ArchConfig, dense_kw, *, mode: str):
    """Queries from ``x (B, S, d)`` over the encoder memory's ``k, v (B, T,
    Kv, hd)``, every key valid: ``mode`` ``"prefill"`` runs B2 with
    ``causal=False`` (k, v as projected), ``"decode"`` B5 with ``kv_len =
    T`` (k, v the cross cache), ``"train"`` the materialized scores of
    ``attention.core``.  All read k and v in the queries' dtype, as the
    reference's ``_core`` does: a bf16 cache under f32 compute is widened,
    so the softmax weights are not rounded to bf16 before the PV product
    (under bf16 compute the cast is a no-op)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = linear.dense(lp["cross_attn"]["wq"], x,
                     **dense_kw).reshape(B, S, H, hd)
    k, v = k.to(q.dtype), v.to(q.dtype)
    if mode == "decode":
        o = nxattn.flash_decode(
            q[:, 0], k.contiguous(), v.contiguous(),
            kv_len=k.shape[1])
        out = o.to(q.dtype).reshape(B, 1, H * hd)
    elif mode == "train":
        out = attn_mod.core(q, k, v, causal=False)
    else:
        out = nxattn.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=False).reshape(B, S, H * hd)
    return linear.dense(lp["cross_attn"]["wo"], out, **dense_kw)


def _dec_layer(lp, x, cross_kv, cfg: ArchConfig, dense_kw, *,
               self_cache: KVCache | None = None, pos: int | None = None,
               cache_dtype=torch.bfloat16):
    """One decoder layer.  Prefill (``self_cache`` None) returns the layer's
    self-attention cache ``(k, v)`` padded to ``dec_len``; decode writes
    the token's K/V into ``self_cache`` at ``pos`` in place."""
    akw = _attn_kw(cfg, dense_kw)
    h_in = rmsnorm(lp["self_norm"], x)
    new_cache = None
    if self_cache is None:
        h, new_cache = attn_mod.prefill_attention(
            lp["self_attn"], h_in, cfg.dec_len, cache_dtype=cache_dtype,
            **akw)
    else:
        h = attn_mod.decode_attention(lp["self_attn"], h_in, self_cache,
                                      pos, **akw)
    x = x + h
    x = x + _cross_attend(lp, rmsnorm(lp["cross_norm"], x), *cross_kv,
                          cfg, dense_kw, mode="prefill" if self_cache is None
                          else "decode")
    x = x + mlp_mod.gelu_mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x), dense_kw)
    return x, new_cache


def _train_dec_layer(lp, y, memory, cfg: ArchConfig, dense_kw):
    k, v = _cross_kv(lp, memory, cfg, dense_kw)
    y = y + attn_mod.attention(lp["self_attn"], rmsnorm(lp["self_norm"], y),
                               flash=False, **_attn_kw(cfg, dense_kw))
    y = y + _cross_attend(lp, rmsnorm(lp["cross_norm"], y), k, v, cfg,
                          dense_kw, mode="train")
    return y + mlp_mod.gelu_mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], y),
                                dense_kw)


def encdec_forward(params, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, dense_kw=None):
    """The teacher-forced training forward: ``(logits (B, S_dec, vocab) in
    the compute dtype, aux)``, aux an f32 zero.  The logits are the tied
    table in float under every system, as in the reference."""
    dense_kw = dense_kw or {}
    memory = _encode(params, cfg, frames, dense_kw, train=True)
    cd = getattr(torch, cfg.compute_dtype)
    S = tokens.shape[1]
    y = embed(params["embed"], tokens, cd) + sinusoidal_positions(
        S, cfg.d_model, device=tokens.device).to(cd)[None]
    for lp in params["dec_layers"]:
        y = remat_call(cfg.remat, _train_dec_layer, lp, y, memory, cfg,
                       dense_kw)
    y = rmsnorm(params["final_norm"], y)
    logits = torch.matmul(y, params["embed"]["table"].to(y.dtype).T)
    return logits, torch.zeros((), dtype=torch.float32, device=y.device)


def _logits(params, y: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits, f32: products of the compute-dtype operands
    summed in f32 (the reference's ``preferred_element_type``)."""
    table = params["embed"]["table"].to(y.dtype)
    return torch.matmul(y.to(torch.float32), table.to(torch.float32).T)


def encdec_prefill(params, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, dense_kw=None,
                   cache_dtype=torch.bfloat16):
    """Encode ``frames``, project each layer's cross K/V once, and prefill
    the decoder over ``tokens``: ``(logits (B, vocab) f32 at the last
    token, cache)``.  The self cache is ``cfg.dec_len`` long."""
    dense_kw = dense_kw or {}
    memory = _encode(params, cfg, frames, dense_kw)
    cd = getattr(torch, cfg.compute_dtype)
    B, S = tokens.shape
    y = embed(params["embed"], tokens, cd) + sinusoidal_positions(
        S, cfg.d_model, device=tokens.device).to(cd)[None]
    cache = init_encdec_cache(cfg, B, memory.shape[1], cache_dtype,
                              tokens.device)
    sc, cc = cache["self"], cache["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        k, v = _cross_kv(lp, memory, cfg, dense_kw)
        y, (kc, vc) = _dec_layer(lp, y, (k, v), cfg, dense_kw,
                                 cache_dtype=cache_dtype)
        sc.k[i], sc.v[i] = kc, vc
        cc.k[i], cc.v[i] = k.to(cache_dtype), v.to(cache_dtype)
        del k, v, kc, vc
    y = rmsnorm(params["final_norm"], y[:, -1:])
    return _logits(params, y)[:, 0], cache


def encdec_decode(params, cfg: ArchConfig, token: torch.Tensor, cache,
                  pos: int, *, dense_kw=None):
    """One decoder step at position ``pos`` (every slot) against the
    prefilled cross memory; the self cache is updated in place.  Returns
    ``(logits (B, vocab) f32, cache)``."""
    dense_kw = dense_kw or {}
    pos = int(pos)
    if not 0 <= pos < cfg.dec_len:
        raise ValueError(f"decoder position {pos} outside the self cache "
                         f"of {cfg.dec_len}")
    cd = getattr(torch, cfg.compute_dtype)
    pe = sinusoidal_positions(pos + 1, cfg.d_model, device=token.device)
    y = embed(params["embed"], token, cd) + pe[pos].to(cd)
    sc, cc = cache["self"], cache["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        y, _ = _dec_layer(lp, y, (cc.k[i], cc.v[i]), cfg, dense_kw,
                          self_cache=KVCache(sc.k[i], sc.v[i]), pos=pos)
    y = rmsnorm(params["final_norm"], y)
    return _logits(params, y)[:, 0], cache
