"""Decoder-only LM, the dense, moe, vlm, ssm and hybrid families: init,
the training forward, prefill, dense-cache decode, paged decode and the
paged speculative verify.

Port of the decoder paths of ``repro/models/transformer.py``.  The
reference's ``lax.scan`` over stacked layer parameters becomes a Python
loop over a list of per-layer parameter dicts.

* dense -- pre-norm GQA attention (qk-norm where the config sets it) +
  SwiGLU (or GELU where ``mlp_type`` says so).
* vlm (pixtral) -- the dense layers, with precomputed patch embeddings
  ``(B, n_img, d)`` prepended to the token embeddings at prefill: the
  prompt is ``n_img + S_text`` positions long.
* moe -- the same attention + a top-k expert layer (``models/moe.py``).
  A :class:`~repro_torch.configs.base.MlaMoeConfig` (the port's own)
  takes latent attention (``attention.mla_prefill_attention`` /
  ``mla_paged_decode_attention``), leading dense SwiGLU layers, expert
  layers with sigmoid routing and shared experts, and an untied
  ``lm_head``; it serves through prefill and paged decode only.  Given the
  prompts' lengths (``lm_prefill(lengths=...)``, host ints), its expert
  layers keep padded rows out of their capacity.
* ssm (mamba2) -- Mamba2 blocks only, attention-free.
* hybrid (zamba2) -- a Mamba2 backbone; after every ``attn_every`` layers a
  *shared* (weight-tied) attention + SwiGLU block runs on
  ``in_proj(concat(hidden, embeddings))`` and is added back to the residual
  stream.  Each application of the shared block has its own KV cache.

The training forward (:func:`lm_forward`) writes no cache and is
differentiable: attention on materialized scores, weights on the per-call
path under ``rns`` / ``sdrns``; with ``cfg.remat`` each layer's body (and
the hybrid family's group of Mamba2 layers with its shared block) is
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  In the sharded train step under ``ShardCtx.seq_shard``
the dense, moe and vlm families take the reference's Megatron-SP
boundaries (its ``_sp`` constraints): the embedding output goes to
sequence shards over tp, the norms and residual adds run there, the
sequence is all-gathered before each matmul block, and the row-parallel
partial sums of ``wo`` and ``w_down`` are reduce-scattered back onto the
shards (the moe output, whole, is cut to them); the final norm runs on the
shards before the logits' gather.  A norm scale used on a shard gets a
gradient partial over tp, summed there.  The ssm and hybrid families run
with no SP, as in the reference.

Caches (stacked over layers on axis 0, updated in place by decode):

* dense, moe, vlm: ``KVCache(k, v)`` with leaves (L, B, S_max, Kv, hd);
  MLA: the latent ``c`` (L, B, S_max, 1, r) and ``k_pe`` (L, B, S_max, 1,
  rope) in the ``k`` and ``v`` leaves (:func:`kv_dims`);
* ssm: ``SsmCache(conv (L, B, K-1, conv_dim), state (L, B, H, P, N))``;
* hybrid: ``{"ssm": SsmCache(...), "attn": KVCache(k, v)}`` with KV leaves
  (G, B, S_max, Kv, hd), G the number of shared-block applications.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, is_mla
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       remat_call, rmsnorm)
from repro_torch.models.ssm import Mamba2Dims, SsmCache
from repro_torch.numerics import kv_pages as kvp
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import ShardedParam, get_shard_ctx

__all__ = ["init_lm", "init_lm_cache", "lm_forward", "lm_prefill",
           "lm_decode", "lm_decode_paged", "lm_verify_paged", "ssm_dims",
           "hybrid_groups", "kv_dims"]


_ATTN_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or (
            cfg.family in _ATTN_FAMILIES
            and cfg.mlp_type in ("swiglu", "gelu")):
        return
    where = (" (the audio family is the encoder-decoder of "
             "models/encdec.py)" if cfg.family == "audio" else "")
    raise ValueError(f"the decoder-only LM serves the dense, moe, vlm, ssm "
                     f"and hybrid families, not "
                     f"{cfg.family!r}/{cfg.mlp_type!r}{where}")


def ssm_dims(cfg: ArchConfig) -> Mamba2Dims:
    return Mamba2Dims(cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                      cfg.ssm_expand, cfg.ssm_headdim)


def kv_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """``(heads, k width, v width)`` of a cache row: ``(n_kv, hd, hd)``, or
    under MLA one latent of ``kv_lora_rank`` and one key of
    ``qk_rope_dim`` a token in the ``k`` and ``v`` leaves."""
    if is_mla(cfg):
        return 1, cfg.kv_lora_rank, cfg.qk_rope_dim
    return cfg.n_kv, cfg.hd, cfg.hd


def _refuse_mla(cfg: ArchConfig, what: str) -> None:
    if is_mla(cfg):
        raise ValueError(f"{cfg.name}: latent attention serves through "
                         f"prefill and paged decode, not {what}")


def hybrid_groups(cfg: ArchConfig) -> tuple[int, int]:
    """(shared-block applications, tail layers) of the hybrid family."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_mla_layer(gen: torch.Generator, cfg, i: int,
                    device) -> dict[str, Any]:
    p = {"attn_norm": init_rmsnorm(cfg.d_model, device),
         "attn": attn_mod.init_mla(gen, cfg, device),
         "mlp_norm": init_rmsnorm(cfg.d_model, device)}
    if i < cfg.first_dense:
        p["mlp"] = mlp_mod.init_swiglu(gen, cfg.d_model, cfg.dense_d_ff,
                                       device)
    else:
        p["moe"] = moe_mod.init_moe_mla(gen, cfg.d_model, cfg.d_ff,
                                        cfg.n_experts, cfg.n_shared, device)
    return p


def _init_layer(gen: torch.Generator, cfg: ArchConfig,
                device, i: int = 0) -> dict[str, Any]:
    if is_mla(cfg):
        return _init_mla_layer(gen, cfg, i, device)
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": init_rmsnorm(cfg.d_model, device),
                "mamba": ssm_mod.init_mamba2(gen, ssm_dims(cfg), device)}
    p = {
        "attn_norm": init_rmsnorm(cfg.d_model, device),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.hd,
                                        qk_norm=cfg.qk_norm, device=device),
        "mlp_norm": init_rmsnorm(cfg.d_model, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, device)
    elif cfg.mlp_type == "gelu":
        p["mlp"] = mlp_mod.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, device)
    else:
        p["mlp"] = mlp_mod.init_swiglu(gen, cfg.d_model, cfg.d_ff, device)
    return p


def _init_shared_block(gen: torch.Generator, cfg: ArchConfig,
                       device) -> dict[str, Any]:
    return {
        "in_proj": linear.init_dense(gen, 2 * cfg.d_model, cfg.d_model,
                                     device),
        "attn_norm": init_rmsnorm(cfg.d_model, device),
        "attn": attn_mod.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv, cfg.hd, device=device),
        "mlp_norm": init_rmsnorm(cfg.d_model, device),
        "mlp": mlp_mod.init_swiglu(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_lm(gen: torch.Generator, cfg: ArchConfig, *, device="cuda",
            prepare_layer: Callable[[dict], dict] | None = None
            ) -> dict[str, Any]:
    """Random parameters, made layer by layer on ``device``.

    ``prepare_layer`` (the residue-resident pass) runs on each layer (and
    the hybrid family's shared block) right after it is made, so only one
    layer's float weights exist at a time.
    """
    _check_family(cfg)
    prep = prepare_layer or (lambda p: p)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        "layers": [prep(_init_layer(gen, cfg, device, i))
                   for i in range(cfg.n_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = prep(linear.init_dense(gen, cfg.d_model,
                                                   cfg.vocab, device))
    if cfg.family == "hybrid":
        params["shared"] = prep(_init_shared_block(gen, cfg, device))
    return params


def init_lm_cache(cfg: ArchConfig, batch: int, s_max: int,
                  dtype=torch.bfloat16, device="cuda"):
    """A zeroed cache of the family's layout (module docstring); the SSM
    state and conv history are f32 whatever ``dtype`` the KV cache has."""
    _check_family(cfg)
    L = cfg.n_layers
    if cfg.family in _ATTN_FAMILIES:
        kv, hk, hv = kv_dims(cfg)
        return KVCache(
            torch.zeros((L, batch, s_max, kv, hk), dtype=dtype,
                        device=device),
            torch.zeros((L, batch, s_max, kv, hv), dtype=dtype,
                        device=device))
    dims = ssm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    ssm_cache = SsmCache(
        torch.zeros((L, batch, dims.d_conv - 1, dims.conv_dim), **f32),
        torch.zeros((L, batch, dims.n_heads, dims.headdim, dims.d_state),
                    **f32))
    if cfg.family == "ssm":
        return ssm_cache
    shape = (hybrid_groups(cfg)[0], batch, s_max, cfg.n_kv, cfg.hd)
    return {"ssm": ssm_cache,
            "attn": KVCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))}


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            dense_kw: dict[str, Any]) -> torch.Tensor:
    """Tied-embedding logits in the compute dtype.  Under ``rns`` and
    ``sdrns`` they run through ``linear.dense`` like every other weight: on
    the resident ``embed.logits_w`` planes of a prepared tree, else on
    ``table.T`` per call."""
    return _head(params, rmsnorm(params["final_norm"], x), dense_kw)


def _head(params, x: torch.Tensor, dense_kw: dict[str, Any]
          ) -> torch.Tensor:
    """The logits matmul of the normed ``x``: the untied ``lm_head`` where
    the tree has one, else the tied embedding; a sharded table (the train
    step) runs as a column plan over its vocabulary."""
    if "lm_head" in params:
        return linear.dense(params["lm_head"], x, **dense_kw).to(x.dtype)
    table = params["embed"]["table"]
    if dense_kw.get("system", "bns") in ("rns", "sdrns"):
        w = params["embed"].get("logits_w")
        if w is None:
            w = table.T if isinstance(table, ShardedParam) else \
                table.to(torch.float32).T
        return linear.dense({"w": w}, x, **dense_kw).to(x.dtype)
    if isinstance(table, ShardedParam):
        return linear.dense({"w": table.T}, x,
                            **{**dense_kw, "compute_dtype": x.dtype})
    return torch.matmul(x, table.to(x.dtype).T)


def _mlp_block(lp, x, cfg: ArchConfig, dense_kw, valid=None, n_tokens=None):
    """The layer's feed-forward half: SwiGLU or GELU, or the expert layer
    of the moe family (an MLA model's: sigmoid routing and shared experts,
    and with ``valid`` / ``n_tokens`` padded rows kept out of the
    capacity; its leading dense layers are SwiGLUs)."""
    h = rmsnorm(lp["mlp_norm"], x)
    if is_mla(cfg):
        if "mlp" in lp:
            return mlp_mod.swiglu(lp["mlp"], h, dense_kw)
        return moe_mod.moe(lp["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k, capacity_factor=cfg.moe_cf,
                           dense_kw=dense_kw,
                           routed_scale=cfg.routed_scale, valid=valid,
                           n_tokens=n_tokens)
    if cfg.family == "moe":
        return moe_mod.moe(lp["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k, capacity_factor=cfg.moe_cf,
                           dense_kw=dense_kw)
    if cfg.mlp_type == "gelu":
        return mlp_mod.gelu_mlp(lp["mlp"], h, dense_kw)
    return mlp_mod.swiglu(lp["mlp"], h, dense_kw)


def _mamba_prefill(lp, x, ssm_c: SsmCache, i: int, cfg: ArchConfig,
                   dense_kw):
    """One Mamba2 layer over the prompt; its final conv history and state go
    to layer ``i`` of the cache."""
    h, c2 = ssm_mod.mamba2_forward(
        lp["mamba"], rmsnorm(lp["norm"], x), ssm_dims(cfg),
        chunk=cfg.ssm_chunk, dense_kw=dense_kw, return_cache=True)
    ssm_c.conv[i], ssm_c.state[i] = c2.conv, c2.state
    return x + h


def _mamba_decode(lp, x, ssm_c: SsmCache, i: int, cfg: ArchConfig,
                  dense_kw):
    """One Mamba2 layer's decode step on layer ``i`` of the cache."""
    h, c2 = ssm_mod.mamba2_decode(
        lp["mamba"], rmsnorm(lp["norm"], x),
        SsmCache(ssm_c.conv[i], ssm_c.state[i]), ssm_dims(cfg),
        dense_kw=dense_kw)
    ssm_c.conv[i], ssm_c.state[i] = c2.conv, c2.state
    return x + h


def _attn_kw(cfg: ArchConfig, dense_kw, *, shared: bool = False):
    """Attention keywords; the hybrid shared block runs without qk-norm."""
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                qk_norm=cfg.qk_norm and not shared,
                rope_theta=cfg.rope_theta, dense_kw=dense_kw)


def _hybrid_schedule(cfg: ArchConfig):
    """``(layer indices, shared-block application or None)`` in order: each
    group of ``attn_every`` Mamba2 layers is followed by the shared block;
    the tail layers by nothing."""
    G, _ = hybrid_groups(cfg)
    ae = cfg.attn_every
    for g in range(G):
        yield range(g * ae, (g + 1) * ae), g
    yield range(G * ae, cfg.n_layers), None


def _shared_in(params, x, x0, dense_kw):
    """The shared block's input: ``in_proj(concat(hidden, embeddings))``."""
    return linear.dense(params["shared"]["in_proj"],
                        torch.cat([x, x0], dim=-1), **dense_kw)


def _shared_out(params, h, a, dense_kw):
    sp = params["shared"]
    h = h + a
    return h + mlp_mod.swiglu(sp["mlp"], rmsnorm(sp["mlp_norm"], h),
                              dense_kw)


def _read_logits(params, cfg, x, logits_at, dense_kw):
    B = x.shape[0]
    if logits_at is not None:
        rows = torch.as_tensor(logits_at, device=x.device).long()
        xg = x[torch.arange(B, device=x.device), rows][:, None]
    else:
        xg = x[:, -1:]
    return _logits(params, cfg, xg, dense_kw)[:, 0]


# ---------------------------------------------------------------------------
# Training forward (full sequence, no cache)
# ---------------------------------------------------------------------------


def _sp_ctx(cfg: ArchConfig):
    """The shard context when the training forward runs sequence-parallel
    (``seq_shard``, an attention family, a tensor axis), else None."""
    ctx = get_shard_ctx()
    if (ctx is None or not ctx.seq_shard or cfg.family not in _ATTN_FAMILIES
            or coll.axis_size(ctx.mesh, ctx.tp) == 1):
        return None
    return ctx


def _to_seq(x, ctx):
    """A replicated (B, S, ·) activation -> this rank's sequence shard."""
    n = coll.axis_size(ctx.mesh, ctx.tp)
    if x.shape[1] % n:
        raise ValueError(f"seq_shard: S {x.shape[1]} does not divide the "
                         f"tensor axes ({n})")
    return coll.diff_slice(x, 1, ctx.mesh, ctx.tp)


def _from_seq(x, ctx):
    """Sequence shards -> the whole sequence before a matmul block; its
    consumers' gradients come back whole on every rank (the column plans
    sum their input's), so the backward keeps this rank's shard."""
    return coll.diff_all_gather(x, 1, ctx.mesh, ctx.tp, "slice")


def _seq_norm(p, x, ctx):
    """RMSNorm on sequence shards: the scale's gradient, partial over tp,
    is summed there."""
    return rmsnorm({"scale": coll.diff_identity(p["scale"], ctx.mesh,
                                                ctx.tp)}, x)


def _residual(x, h):
    """The residual add of the training forward (on sequence shards under
    SP)."""
    return x + h


def _train_layer_sp(lp, x, cfg: ArchConfig, dense_kw, ctx):
    """:func:`_train_layer` on sequence shards (module docstring)."""
    def back(h):                # a row plan's output, or a whole one
        return h if h.shape[1] == x.shape[1] else _to_seq(h, ctx)

    hn = _from_seq(_seq_norm(lp["attn_norm"], x, ctx), ctx)
    with linear.seq_scatter():
        x = _residual(x, back(attn_mod.attention(
            lp["attn"], hn, flash=False, **_attn_kw(cfg, dense_kw))))
    hn = _from_seq(_seq_norm(lp["mlp_norm"], x, ctx), ctx)
    if cfg.family == "moe":
        h, aux = moe_mod.moe(lp["moe"], hn, n_experts=cfg.n_experts,
                             top_k=cfg.top_k, capacity_factor=cfg.moe_cf,
                             dense_kw=dense_kw, with_aux=True)
        return _residual(x, _to_seq(h, ctx)), aux
    with linear.seq_scatter():
        fn = mlp_mod.gelu_mlp if cfg.mlp_type == "gelu" else mlp_mod.swiglu
        return _residual(x, back(fn(lp["mlp"], hn, dense_kw))), None


def _train_layer(lp, x, cfg: ArchConfig, dense_kw):
    """One attention layer of the training forward: ``(x, aux)``."""
    ctx = _sp_ctx(cfg)
    if ctx is not None:
        return _train_layer_sp(lp, x, cfg, dense_kw, ctx)
    x = _residual(x, attn_mod.attention(lp["attn"],
                                        rmsnorm(lp["attn_norm"], x),
                                        flash=False,
                                        **_attn_kw(cfg, dense_kw)))
    if cfg.family == "moe":
        h, aux = moe_mod.moe(lp["moe"], rmsnorm(lp["mlp_norm"], x),
                             n_experts=cfg.n_experts, top_k=cfg.top_k,
                             capacity_factor=cfg.moe_cf, dense_kw=dense_kw,
                             with_aux=True)
        return _residual(x, h), aux
    return _residual(x, _mlp_block(lp, x, cfg, dense_kw)), None


def _train_mamba(lp, x, cfg: ArchConfig, dense_kw):
    return x + ssm_mod.mamba2_forward(lp["mamba"], rmsnorm(lp["norm"], x),
                                      ssm_dims(cfg), chunk=cfg.ssm_chunk,
                                      dense_kw=dense_kw)


def _train_group(params, layers, x, x0, cfg: ArchConfig, dense_kw):
    """A hybrid group: its Mamba2 layers, then the shared block."""
    for i in layers:
        x = remat_call(cfg.remat, _train_mamba, params["layers"][i], x, cfg,
                       dense_kw)
    h = _shared_in(params, x, x0, dense_kw)
    sp = params["shared"]
    a = attn_mod.attention(sp["attn"], rmsnorm(sp["attn_norm"], h),
                           flash=False, **_attn_kw(cfg, dense_kw,
                                                   shared=True))
    return x + _shared_out(params, h, a, dense_kw)


def lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
               patches: torch.Tensor | None = None, dense_kw=None):
    """The training forward: tokens (B, S_text) -> ``(logits (B, S, vocab)
    in the compute dtype, aux)``, aux the moe layers' summed load-balance
    loss (an f32 zero for the other families).  ``patches`` (vlm): ``(B,
    n_img, d)`` before the tokens, S = n_img + S_text.  Writes no cache."""
    _check_family(cfg)
    _refuse_mla(cfg, "the training forward")
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(device=x.device, dtype=cd), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    r = cfg.remat
    sp = _sp_ctx(cfg)
    if sp is not None:
        x = _to_seq(x, sp)
    if cfg.family in _ATTN_FAMILIES:
        for lp in params["layers"]:
            x, a = remat_call(r, _train_layer, lp, x, cfg, dense_kw)
            aux = aux if a is None else aux + a
        if sp is not None:
            x = _from_seq(_seq_norm(params["final_norm"], x, sp), sp)
            return _head(params, x, dense_kw), aux
    elif cfg.family == "ssm":
        for lp in params["layers"]:
            x = remat_call(r, _train_mamba, lp, x, cfg, dense_kw)
    else:
        x0 = x
        for layers, g in _hybrid_schedule(cfg):
            if g is None:           # the tail: Mamba2 layers alone
                for i in layers:
                    x = remat_call(r, _train_mamba, params["layers"][i], x,
                                   cfg, dense_kw)
            else:
                x = remat_call(r, _train_group, params, layers, x, x0, cfg,
                               dense_kw)
    return _logits(params, cfg, x, dense_kw), aux


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def lm_prefill(params, cfg: ArchConfig, tokens: torch.Tensor, *,
               s_max: int | None = None, dense_kw=None,
               cache_dtype=torch.bfloat16, logits_at=None, patches=None,
               lengths=None):
    """Process the prompt; return ``(logits (B, vocab), cache)`` with the
    cache of the family's layout (module docstring), KV padded to
    ``s_max`` rows.

    ``logits_at``: optional (B,) positions to read logits from instead of
    the last row.  ``patches`` (vlm): ``(B, n_img, d)`` embeddings put
    before the tokens' (the positions count them).  ``lengths``: the
    right-padded prompts' lengths, host ints (an MLA model's expert layers
    keep the padding out of their capacity; others ignore it).
    """
    _check_family(cfg)
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(device=x.device, dtype=cd), x], dim=1)
    B, S = x.shape[:2]
    s_max = S if s_max is None else s_max
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, x, s_max, dense_kw, cache_dtype,
                               logits_at)
    if is_mla(cfg):
        return _mla_prefill(params, cfg, x, s_max, dense_kw, cache_dtype,
                            logits_at, lengths)
    cache = init_lm_cache(cfg, B, s_max, cache_dtype, x.device)
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _mamba_prefill(lp, x, cache, i, cfg, dense_kw)
        return _read_logits(params, cfg, x, logits_at, dense_kw), cache
    akw = _attn_kw(cfg, dense_kw)
    for i, lp in enumerate(params["layers"]):
        h, (kc, vc) = attn_mod.prefill_attention(
            lp["attn"], rmsnorm(lp["attn_norm"], x), s_max,
            cache_dtype=cache_dtype, **akw)
        cache.k[i], cache.v[i] = kc, vc
        x = x + h
        x = x + _mlp_block(lp, x, cfg, dense_kw)
    return _read_logits(params, cfg, x, logits_at, dense_kw), cache


def _mla_prefill(params, cfg, x, s_max, dense_kw, cache_dtype, logits_at,
                 lengths):
    B, S = x.shape[:2]
    valid = n_tokens = None
    if lengths is not None:
        lens = [int(n) for n in lengths]
        n_tokens = sum(lens)
        if n_tokens < B * S:
            valid = (torch.arange(S, device=x.device)[None, :]
                     < torch.as_tensor(lens, device=x.device)[:, None])
    cache = init_lm_cache(cfg, B, s_max, cache_dtype, x.device)
    for i, lp in enumerate(params["layers"]):
        h, (c, k_pe) = attn_mod.mla_prefill_attention(
            lp["attn"], rmsnorm(lp["attn_norm"], x), s_max, cfg=cfg,
            dense_kw=dense_kw, cache_dtype=cache_dtype)
        cache.k[i], cache.v[i] = c, k_pe
        x = x + h
        x = x + _mlp_block(lp, x, cfg, dense_kw, valid=valid,
                           n_tokens=n_tokens)
    return _read_logits(params, cfg, x, logits_at, dense_kw), cache


def _hybrid_prefill(params, cfg, x, s_max, dense_kw, cache_dtype,
                    logits_at):
    B = x.shape[0]
    cache = init_lm_cache(cfg, B, s_max, cache_dtype, x.device)
    ssm_c, kv = cache["ssm"], cache["attn"]
    skw = _attn_kw(cfg, dense_kw, shared=True)
    sp = params["shared"]
    x0 = x
    for layers, g in _hybrid_schedule(cfg):
        for i in layers:
            x = _mamba_prefill(params["layers"][i], x, ssm_c, i, cfg,
                               dense_kw)
        if g is None:
            continue
        h = _shared_in(params, x, x0, dense_kw)
        a, (kc, vc) = attn_mod.prefill_attention(
            sp["attn"], rmsnorm(sp["attn_norm"], h), s_max,
            cache_dtype=cache_dtype, **skw)
        kv.k[g], kv.v[g] = kc, vc
        x = x + _shared_out(params, h, a, dense_kw)
    return _read_logits(params, cfg, x, logits_at, dense_kw), cache


# ---------------------------------------------------------------------------
# Decode over the dense cache (one token, every slot at one position)
# ---------------------------------------------------------------------------


def lm_decode(params, cfg: ArchConfig, token: torch.Tensor, cache, pos: int,
              *, dense_kw=None):
    """One decode step.  token: (B, 1) int; pos: the position every slot
    decodes at.  The cache (``lm_prefill``'s layout) is updated in place;
    returns ``(logits (B, vocab), cache)``."""
    _check_family(cfg)
    _refuse_mla(cfg, "the dense-cache decode")
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], token, cd)
    pos = int(pos)
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, x, cache, pos, dense_kw)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _mamba_decode(lp, x, cache, i, cfg, dense_kw)
    else:
        akw = _attn_kw(cfg, dense_kw)
        for i, lp in enumerate(params["layers"]):
            x = x + attn_mod.decode_attention(
                lp["attn"], rmsnorm(lp["attn_norm"], x),
                KVCache(cache.k[i], cache.v[i]), pos, **akw)
            x = x + _mlp_block(lp, x, cfg, dense_kw)
    return _logits(params, cfg, x, dense_kw)[:, 0], cache


def _hybrid_decode(params, cfg, x, cache, pos, dense_kw):
    ssm_c, kv = cache["ssm"], cache["attn"]
    skw = _attn_kw(cfg, dense_kw, shared=True)
    sp = params["shared"]
    x0 = x
    for layers, g in _hybrid_schedule(cfg):
        for i in layers:
            x = _mamba_decode(params["layers"][i], x, ssm_c, i, cfg, dense_kw)
        if g is None:
            continue
        h = _shared_in(params, x, x0, dense_kw)
        a = attn_mod.decode_attention(
            sp["attn"], rmsnorm(sp["attn_norm"], h),
            KVCache(kv.k[g], kv.v[g]), pos, **skw)
        x = x + _shared_out(params, h, a, dense_kw)
    return x


# ---------------------------------------------------------------------------
# Decode over the paged pool (dense and moe families)
# ---------------------------------------------------------------------------


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
    if cfg.family not in _ATTN_FAMILIES:
        raise ValueError(f"paged decode supports the dense, moe and vlm "
                         f"families, not {cfg.family!r}")
    _check_family(cfg)
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], token, cd)
    if is_mla(cfg):
        if with_syndrome:
            raise ValueError(f"{cfg.name}: no syndrome decode over latent "
                             f"pages")
        for i, lp in enumerate(params["layers"]):
            h, lay = attn_mod.mla_paged_decode_attention(
                lp["attn"], rmsnorm(lp["attn_norm"], x),
                kvp.layer_slice(kv, i), block_tab, pos, page_size=page_size,
                cfg=cfg, dense_kw=dense_kw, cache_dtype=cache_dtype)
            kv = kvp.layer_update(kv, i, lay)
            x = x + h
            x = x + _mlp_block(lp, x, cfg, dense_kw)
        return _logits(params, cfg, x, dense_kw)[:, 0], kv
    akw = dict(_attn_kw(cfg, dense_kw), cache_dtype=cache_dtype,
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
        x = x + _mlp_block(lp, x, cfg, dense_kw)
    logits = _logits(params, cfg, x, dense_kw)[:, 0]
    if with_syndrome:
        return logits, kv, torch.stack(syns, dim=1)
    return logits, kv


def lm_verify_paged(params, cfg: ArchConfig, tokens: torch.Tensor,
                    kv: "kvp.PagedKV", block_tab: torch.Tensor,
                    pos: torch.Tensor, *, page_size: int, dense_kw=None,
                    cache_dtype=torch.bfloat16):
    """Speculative verify: V tokens a slot in one batched paged step (the
    pool updated in place).

    tokens: (B, V) int, each slot's current last token then ``V - 1``
    drafted ones, at positions ``pos[b] .. pos[b] + V - 1``.  Returns
    ``(logits (B, V, vocab), kv)``: row ``j`` is the target's distribution
    after ``tokens[:, j]``, over the prefix a sequential decode would have
    seen.  The layers are :func:`lm_decode_paged`'s with the token axis
    widened from 1 to V: every weight matmul runs over ``B * V`` rows.
    """
    if cfg.family not in _ATTN_FAMILIES:
        raise ValueError(f"paged verify supports the dense, moe and vlm "
                         f"families, not {cfg.family!r}")
    _check_family(cfg)
    _refuse_mla(cfg, "the speculative verify")
    dense_kw = dense_kw or {}
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    V = tokens.shape[1]
    positions = pos.to(device=x.device, dtype=torch.int32)[:, None] + \
        torch.arange(V, dtype=torch.int32, device=x.device)[None, :]
    akw = dict(_attn_kw(cfg, dense_kw), cache_dtype=cache_dtype)
    for i, lp in enumerate(params["layers"]):
        h, lay = attn_mod.paged_verify_attention(
            lp["attn"], rmsnorm(lp["attn_norm"], x), kvp.layer_slice(kv, i),
            block_tab, positions, page_size=page_size, **akw)
        kv = kvp.layer_update(kv, i, lay)
        x = x + h
        x = x + _mlp_block(lp, x, cfg, dense_kw)
    return _logits(params, cfg, x, dense_kw), kv
