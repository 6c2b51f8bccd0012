"""Grouped-query attention with qk-norm: prefill and paged decode.

Port of ``repro/models/attention.py`` for the serving path.  Prefill runs
the causal flash attention kernel and hands back this layer's KV cache
(zero-padded to ``s_max``); paged decode appends the new token's K/V to its
page and runs the split-KV paged decode kernel over the slot's page list.
KV heads stay ungrouped ``(B, T, Kv, hd)``; the kernels map query head
``h`` onto KV head ``h // (H // Kv)``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import linear
from repro_torch.models.layers import init_rmsnorm, rmsnorm, rope
from repro_torch.numerics import attention as nxattn
from repro_torch.numerics import kv_pages as nxkv

__all__ = ["init_attention", "prefill_attention", "paged_decode_attention"]


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
                 rope_theta, dense_kw):
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
    q = rope(q, positions, theta=rope_theta)
    k = rope(k, positions, theta=rope_theta)
    return q, k, v


def _full_seq(q, k, v, *, causal, n_heads, head_dim):
    """Full-sequence attention through the flash kernel (q rows sit at
    positions 0..Sq-1 against KV rows 0..T-1)."""
    B, S = q.shape[0], q.shape[1]
    out = nxattn.flash_attention(q.contiguous(),
                                 k.to(q.dtype).contiguous(),
                                 v.to(q.dtype).contiguous(), causal=causal)
    return out.reshape(B, S, n_heads * head_dim)


def prefill_attention(params, x, s_max: int, *, n_heads, n_kv, head_dim,
                      qk_norm=False, rope_theta=1e4, dense_kw=None,
                      cache_dtype=torch.bfloat16, causal=True):
    """Self-attention over the prompt; also returns this layer's KV cache
    ``(k, v)``, each ``(B, s_max, Kv, hd)`` in ``cache_dtype``."""
    dense_kw = dense_kw or {}
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, qk_norm=qk_norm,
                           positions=positions, rope_theta=rope_theta,
                           dense_kw=dense_kw)
    pad = (0, 0, 0, 0, 0, s_max - S)
    cache = (torch.nn.functional.pad(k.to(cache_dtype), pad),
             torch.nn.functional.pad(v.to(cache_dtype), pad))
    out = _full_seq(q, k, v, causal=causal, n_heads=n_heads,
                    head_dim=head_dim)
    return linear.dense(params["wo"], out, **dense_kw), cache


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
