"""Grouped-query attention with qk-norm: training, prefill, dense and paged
decode.

Port of ``repro/models/attention.py``.  Prefill runs the flash attention
kernel (causal, or not: the encoder of the audio family) and hands back
this layer's KV cache (zero-padded to ``s_max``).  :func:`attention` runs a
whole sequence with no cache: on the flash kernel by default (the
encoder's serving prefill) or, with ``flash=False``, on the materialized
scores of :func:`core` (over 1024-row query chunks above 8192 positions),
the differentiable path the training forward takes, as the reference's
does (the kernels define no backward).  Dense decode writes the new
token's K/V into the layer's contiguous cache in place and runs the
split-KV decode kernel over it; paged decode appends them to the slot's
page and runs the split-KV paged decode kernel over the slot's page list;
the speculative verify appends a block of V tokens a slot and runs the
same kernel with the V rows folded into its batch.  KV heads stay
ungrouped ``(B, T, Kv, hd)``; the kernels map query head ``h`` onto KV
head ``h // (H // Kv)``.  Under a shard context the kernels run in both
plane layouts (``numerics/attention.py`` splits the batch over dp): the
reference's switch to materialized scores under its column layout is not
copied.  The attention width ``n_heads * head_dim`` may
differ from ``d_model`` (pixtral-12b's is 4096 against 5120): ``wq`` maps
onto it and ``wo`` back.  ``apply_rope=False`` (the audio family, whose
positions are sinusoidal embeddings added to the input) leaves q and k
unrotated.

Multi-head latent attention (MLA, the port's
:class:`~repro_torch.configs.base.MlaMoeConfig`): :func:`mla_prefill_attention`
projects q (``wq``, ``n_heads x (nope + rope)``), the latent ``c_kv`` and
the shared rotary key ``k_pe`` (``kv_a``, then ``kv_norm`` on the latent),
expands the latent into every head's ``k_nope`` and value (``kv_b``),
rotates the rope parts in DeepSeek-V3's pairing, and runs the flash kernel
with q and k of ``nope + rope`` and v of ``v_head_dim`` values a head.  Its
cache is the normed latent and the roped ``k_pe``, ``(B, s_max, 1, r)`` and
``(B, s_max, 1, rope)``: one latent and one key a token for all heads,
which the paged pool keeps as its K and V pages.
:func:`mla_paged_decode_attention` appends the new token's latent and key
to the pages, reads the slot's pages back, expands them with ``kv_b`` and
runs the flash kernel over ``kv_len`` rows: the expansion runs in eager
ops over every row of the slot's pages each step.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tracing
from repro_torch.models import linear
from repro_torch.models.layers import init_rmsnorm, rmsnorm, rope
from repro_torch.numerics import attention as nxattn
from repro_torch.numerics import kv_pages as nxkv
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.quant import true_divide

__all__ = ["KVCache", "init_attention", "attention", "core",
           "prefill_attention", "decode_attention", "paged_decode_attention",
           "paged_verify_attention", "init_mla", "mla_prefill_attention",
           "mla_paged_decode_attention"]

CHUNK_THRESHOLD = 8192   # above this S, scores go over query chunks
Q_CHUNK = 1024


class KVCache(NamedTuple):
    k: torch.Tensor   # (..., B, S_max, Kv, hd)
    v: torch.Tensor


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qk_norm: bool = False,
                   device="cuda") -> dict[str, Any]:
    p = {
        "wq": linear.init_dense(gen, d_model, n_heads * head_dim, device),
        "wk": linear.init_dense(gen, d_model, n_kv * head_dim, device),
        "wv": linear.init_dense(gen, d_model, n_kv * head_dim, device),
        "wo": linear.init_dense(gen, n_heads * head_dim, d_model, device),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(head_dim, device)
        p["k_norm"] = init_rmsnorm(head_dim, device)
    return p


def _project_qkv(params, x, *, n_heads, n_kv, head_dim, qk_norm, positions,
                 rope_theta, dense_kw, apply_rope=True):
    B, S, _ = x.shape
    q = linear.dense(params["wq"], x, **dense_kw).reshape(B, S, n_heads,
                                                          head_dim)
    k = linear.dense(params["wk"], x, **dense_kw).reshape(B, S, n_kv,
                                                          head_dim)
    v = linear.dense(params["wv"], x, **dense_kw).reshape(B, S, n_kv,
                                                          head_dim)
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if apply_rope:
        q = rope(q, positions, theta=rope_theta)
        k = rope(k, positions, theta=rope_theta)
    return q, k, v


def core(q, k, v, *, causal: bool, q_pos=None, kv_pos=None):
    """Exact softmax attention on materialized scores (the reference's
    ``_core``).  q: (B, Sq, H, hd); k, v: (B, T, Kv, hd) -> (B, Sq, H * hd).

    Grouped-query heads run as a grouped einsum over (Kv, g): the KV heads
    are never repeated.  Scores are f32 products of the operands, scaled by
    1 / sqrt(hd), masked to -1e30 where a key lies after its query
    (``causal``, by ``q_pos`` / ``kv_pos``, 0.. by default), and
    softmaxed in f32; the PV product runs in v's dtype.
    """
    B, Sq, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, hd)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32),
                          k.to(torch.float32)).reshape(B, H, Sq, T)
    scores = true_divide(scores, hd ** 0.5)
    if causal:
        dev = q.device
        q_pos = torch.arange(Sq, device=dev) if q_pos is None else q_pos
        kv_pos = torch.arange(T, device=dev) if kv_pos is None else kv_pos
        scores = scores.masked_fill(kv_pos[None, :] > q_pos[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    pg = probs.reshape(B, Kv, H // Kv, Sq, T).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", pg, v)
    return out.reshape(B, Sq, H * hd)


def _chunked(q, k, v, *, causal):
    """:func:`core` over ``Q_CHUNK`` query rows at a time (long sequences):
    the scores of one chunk are live at a time."""
    pos = torch.arange(k.shape[1], device=q.device)
    outs = [core(q[:, c: c + Q_CHUNK], k, v, causal=causal,
                 q_pos=pos[c: c + Q_CHUNK], kv_pos=pos)
            for c in range(0, q.shape[1], Q_CHUNK)]
    return torch.cat(outs, dim=1)


def _full_seq(q, k, v, *, causal, n_heads, head_dim, flash=True):
    """Full-sequence attention (q rows at positions 0..Sq-1 against KV rows
    0..T-1): the flash kernel, or with ``flash=False`` the materialized
    scores (``_chunked`` above ``CHUNK_THRESHOLD`` rows in whole chunks,
    as the reference picks)."""
    B, S = q.shape[0], q.shape[1]
    if not flash:
        k, v = k.to(q.dtype), v.to(q.dtype)
        if S <= CHUNK_THRESHOLD or S % Q_CHUNK:
            return core(q, k, v, causal=causal)
        return _chunked(q, k, v, causal=causal)
    out = nxattn.flash_attention(q.contiguous(),
                                 k.to(q.dtype).contiguous(),
                                 v.to(q.dtype).contiguous(), causal=causal)
    return out.reshape(B, S, n_heads * head_dim)


def attention(params, x, *, n_heads, n_kv, head_dim, causal=True,
              qk_norm=False, rope_theta=1e4, dense_kw=None,
              apply_rope=True, flash=True) -> torch.Tensor:
    """Self-attention over a whole sequence at positions ``0..S-1``, no
    cache: on the flash kernel (the encoder's prefill), or with
    ``flash=False`` on materialized scores (training: differentiable)."""
    dense_kw = dense_kw or {}
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=positions, rope_theta=rope_theta,
                           dense_kw=dense_kw, apply_rope=apply_rope)
    out = _full_seq(q, k, v, causal=causal, n_heads=n_heads,
                    head_dim=head_dim, flash=flash)
    return linear.dense(params["wo"], out, **dense_kw)


def prefill_attention(params, x, s_max: int, *, n_heads, n_kv, head_dim,
                      qk_norm=False, rope_theta=1e4, dense_kw=None,
                      cache_dtype=torch.bfloat16, causal=True,
                      apply_rope=True):
    """Self-attention over the prompt; also returns this layer's KV cache
    ``(k, v)``, each ``(B, s_max, Kv, hd)`` in ``cache_dtype``."""
    dense_kw = dense_kw or {}
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=positions, rope_theta=rope_theta,
                           dense_kw=dense_kw, apply_rope=apply_rope)
    pad = (0, 0, 0, 0, 0, s_max - S)
    cache = (torch.nn.functional.pad(k.to(cache_dtype), pad),
             torch.nn.functional.pad(v.to(cache_dtype), pad))
    out = _full_seq(q, k, v, causal=causal, n_heads=n_heads,
                    head_dim=head_dim)
    return linear.dense(params["wo"], out, **dense_kw), cache


def decode_attention(params, x, cache: KVCache, pos: int, *, n_heads, n_kv,
                     head_dim, qk_norm=False, rope_theta=1e4,
                     dense_kw=None, apply_rope=True) -> torch.Tensor:
    """One decode step over one layer's dense cache, every slot at ``pos``.

    x: (B, 1, D); cache: this layer's ``(B, S_max, Kv, hd)`` views.  The
    new token's K/V are cast to the cache dtype and written at ``pos`` in
    place (the reference's ``dynamic_update_slice``); attention then reads
    the cache with ``kv_len = pos + 1``.  Returns (B, 1, D).
    """
    dense_kw = dense_kw or {}
    B = x.shape[0]
    pos_t = torch.full((B,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=pos_t[:, None], rope_theta=rope_theta,
                           dense_kw=dense_kw, apply_rope=apply_rope)
    cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
    o = nxattn.flash_decode(q[:, 0], cache.k, cache.v, kv_len=pos + 1)
    out = o.to(q.dtype).reshape(B, 1, n_heads * head_dim)
    return linear.dense(params["wo"], out, **dense_kw)


def paged_decode_attention(params, x, kv_layer: "nxkv.PagedKV",
                           block_tab: torch.Tensor, pos: torch.Tensor, *,
                           page_size: int, n_heads, n_kv, head_dim,
                           qk_norm=False, rope_theta=1e4, dense_kw=None,
                           cache_dtype=torch.bfloat16, with_syndrome=False):
    """One decode step over one layer's paged pool.

    x: (B, 1, D); pos: (B,) int32 per-slot positions.  The new token's K/V
    are cast to ``cache_dtype`` (so decode-appended residue pages hold the
    same bytes prefill-scattered ones would) and written into page
    ``block_tab[b, pos // ps]`` at offset ``pos % ps``; attention then
    walks the slot's page list with ``kv_len = pos + 1``.
    ``with_syndrome=True`` (rns8r pages) also returns the layer's (B,)
    in-kernel syndrome count: ``(out, kv_layer, syn)``.
    """
    dense_kw = dense_kw or {}
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int32)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=pos[:, None], rope_theta=rope_theta,
                           dense_kw=dense_kw)
    n_pmax = block_tab.shape[1]
    page_idx = torch.clamp(pos // page_size, 0, n_pmax - 1).long()
    pages = torch.gather(block_tab.long(), 1, page_idx[:, None])[:, 0]
    offs = pos % page_size
    kv_layer = nxkv.append_token(kv_layer, k[:, 0].to(cache_dtype),
                                 v[:, 0].to(cache_dtype), pages, offs)
    o = nxattn.paged_decode(q[:, 0], kv_layer, block_tab, pos + 1,
                            page_size=page_size, syndrome=with_syndrome)
    if with_syndrome:
        o, syn = o
    out = o.to(q.dtype).reshape(B, 1, n_heads * head_dim)
    out = linear.dense(params["wo"], out, **dense_kw)
    if with_syndrome:
        return out, kv_layer, syn
    return out, kv_layer


def paged_verify_attention(params, x, kv_layer: "nxkv.PagedKV",
                           block_tab: torch.Tensor, positions: torch.Tensor,
                           *, page_size: int, n_heads, n_kv, head_dim,
                           qk_norm=False, rope_theta=1e4, dense_kw=None,
                           cache_dtype=torch.bfloat16):
    """The speculative verify step over one layer's paged pool.

    x: (B, V, D), each slot's current last token and ``V - 1`` drafted ones
    at ``positions (B, V)``.  All V rows' K/V go into the slot's pages in
    one write (:func:`nxkv.append_token` with (B, V) page and offset
    grids), then each row attends over its own prefix in one folded launch
    (:func:`nxattn.paged_verify`).  Row ``j`` equals a sequential decode
    that had emitted rows ``< j``: it reads only rows the acceptance rule
    has already pinned.  Positions past the block table go to the dump page
    (page 0), not into the slot's last page as the one-token decode's clamp
    would: a speculative tail may overshoot the allocation, and clamping
    would overwrite live rows.  Returns ``(out (B, V, D), kv_layer)``.
    """
    dense_kw = dense_kw or {}
    B, V, _ = x.shape
    positions = positions.to(device=x.device, dtype=torch.int32)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=positions, rope_theta=rope_theta,
                           dense_kw=dense_kw)
    n_pmax = block_tab.shape[1]
    page_idx = (positions // page_size).long()
    pages = torch.gather(block_tab.long(), 1,
                         torch.clamp(page_idx, 0, n_pmax - 1))
    pages = torch.where(page_idx < n_pmax, pages, 0)   # overshoot: dump
    kv_layer = nxkv.append_token(kv_layer, k.to(cache_dtype),
                                 v.to(cache_dtype), pages,
                                 positions % page_size)
    o = nxattn.paged_verify(q, kv_layer, block_tab, positions + 1,
                            page_size=page_size)
    out = o.to(q.dtype).reshape(B, V, n_heads * head_dim)
    return linear.dense(params["wo"], out, **dense_kw), kv_layer


# ---------------------------------------------------------------------------
# Multi-head latent attention (module docstring)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg, device="cuda") -> dict[str, Any]:
    """MLA parameters of a :class:`~repro_torch.configs.base.MlaMoeConfig`:
    ``wq (d, H (nope + rope))``, ``kv_a (d, r + rope)``, ``kv_norm (r,)``,
    ``kv_b (r, H (nope + v))``, ``wo (H v, d)``."""
    d, H = cfg.d_model, cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    return {
        "wq": linear.init_dense(gen, d, H * (dn + dr), device),
        "kv_a": linear.init_dense(gen, d, r + dr, device),
        "kv_norm": init_rmsnorm(r, device),
        "kv_b": linear.init_dense(gen, r, H * (dn + dv), device),
        "wo": linear.init_dense(gen, H * dv, d, device),
    }


def _mla_q(params, x, positions, cfg, dense_kw):
    """q (B, S, H, nope + rope), its rope part rotated."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_dim
    q = linear.dense(params["wq"], x, **dense_kw).reshape(
        B, S, cfg.n_heads, dn + cfg.qk_rope_dim)
    q_pe = rope(q[..., dn:], positions, theta=cfg.rope_theta,
                pairing="interleaved")
    return torch.cat([q[..., :dn], q_pe], dim=-1)


def _mla_latent(params, x, positions, cfg, dense_kw):
    """The cache a token leaves: the normed latent ``c (B, S, r)`` and the
    roped shared key ``k_pe (B, S, rope)``."""
    r = cfg.kv_lora_rank
    ckv = linear.dense(params["kv_a"], x, **dense_kw)
    c = rmsnorm(params["kv_norm"], ckv[..., :r])
    k_pe = rope(ckv[..., None, r:], positions, theta=cfg.rope_theta,
                pairing="interleaved")[..., 0, :]
    return c, k_pe


def _mla_expand(params, c, k_pe, cfg, dense_kw):
    """Every head's k ``(B, T, H, nope + rope)`` (``k_pe`` broadcast over
    the heads) and v ``(B, T, H, v)`` from the latent rows."""
    B, T, _ = c.shape
    H, dn = cfg.n_heads, cfg.qk_nope_dim
    kv = linear.dense(params["kv_b"], c, **dense_kw).reshape(
        B, T, H, dn + cfg.v_head_dim)
    k = torch.cat([kv[..., :dn],
                   k_pe[:, :, None, :].expand(B, T, H, k_pe.shape[-1])],
                  dim=-1)
    return k, kv[..., dn:]


def mla_prefill_attention(params, x, s_max: int, *, cfg, dense_kw=None,
                          cache_dtype=torch.bfloat16):
    """MLA over the prompt (module docstring): ``(out (B, S, d), (c, k_pe))``
    with the latent cache ``(B, s_max, 1, r)`` and ``(B, s_max, 1, rope)``
    in ``cache_dtype``."""
    dense_kw = dense_kw or {}
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q = _mla_q(params, x, positions, cfg, dense_kw)
    with tracing.span("attn.latent"):
        c, k_pe = _mla_latent(params, x, positions, cfg, dense_kw)
        k, v = _mla_expand(params, c, k_pe, cfg, dense_kw)
    pad = (0, 0, 0, 0, 0, s_max - S)
    cache = (torch.nn.functional.pad(c[:, :, None].to(cache_dtype), pad),
             torch.nn.functional.pad(k_pe[:, :, None].to(cache_dtype), pad))
    out = nxattn.flash_attention(q.contiguous(), k.to(q.dtype).contiguous(),
                                 v.to(q.dtype).contiguous(), causal=True)
    out = out.reshape(B, S, cfg.n_heads * cfg.v_head_dim)
    return linear.dense(params["wo"], out, **dense_kw), cache


def _page_rows(leaf, tab: torch.Tensor) -> torch.Tensor:
    """One layer's pages of every slot, ``(B, n_pmax * ps, hd)`` f32: dense
    pages as they are, residue pages decoded (lane 0) and scaled."""
    if not isinstance(leaf, ResidueTensor):
        rows = leaf[tab]                               # (B, n, ps, 1, hd)
    else:
        vals = leaf.mset.packed().decode(leaf.planes[tab][..., 0, :, :]
                                         .to(torch.int32))
        rows = vals.to(torch.float32) * leaf.scale[tab]
    B, n, ps = rows.shape[:3]
    return rows.reshape(B, n * ps, rows.shape[-1]).to(torch.float32)


def mla_paged_decode_attention(params, x, kv_layer: "nxkv.PagedKV",
                               block_tab: torch.Tensor, pos: torch.Tensor, *,
                               page_size: int, cfg, dense_kw=None,
                               cache_dtype=torch.bfloat16):
    """One MLA decode step over one layer's latent pages (module
    docstring): the new token's latent and key go into page
    ``block_tab[b, pos // ps]`` at ``pos % ps`` (cast to ``cache_dtype``
    first, as the prefill's are), then the slot's pages are read back,
    expanded and attended over ``kv_len = pos + 1`` rows.  Returns ``(out
    (B, 1, d), kv_layer)``."""
    dense_kw = dense_kw or {}
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int32)
    q = _mla_q(params, x, pos[:, None], cfg, dense_kw)
    n_pmax = block_tab.shape[1]
    page_idx = torch.clamp(pos // page_size, 0, n_pmax - 1).long()
    pages = torch.gather(block_tab.long(), 1, page_idx[:, None])[:, 0]
    tab = block_tab.long()
    with tracing.span("attn.latent"):
        c, k_pe = _mla_latent(params, x, pos[:, None], cfg, dense_kw)
        kv_layer = nxkv.append_token(kv_layer, c[:, 0, None].to(cache_dtype),
                                     k_pe[:, 0, None].to(cache_dtype),
                                     pages, pos % page_size)
        cd = x.dtype
        k, v = _mla_expand(params, _page_rows(kv_layer.k, tab).to(cd),
                           _page_rows(kv_layer.v, tab).to(cd), cfg, dense_kw)
    o = nxattn.flash_attention(q.contiguous(), k.to(q.dtype).contiguous(),
                               v.to(q.dtype).contiguous(), causal=False,
                               kv_len=pos + 1)
    out = o.reshape(B, 1, cfg.n_heads * cfg.v_head_dim)
    return linear.dense(params["wo"], out, **dense_kw), kv_layer
