"""Attention ops behind the numerics registry.

* :func:`flash_attention` -- GQA-native causal attention over the model
  layouts ``q (B, Sq, H, hd)`` / ``k, v (B, T, Kv, hd)`` (prefill).
* :func:`paged_decode` -- one-token split-KV attention over one layer's
  paged pool: the kernel emits one ``(o, m, l)`` partial per block-table
  entry and :func:`merge_decode_partials` combines them.

The implementation follows the device of ``q`` (numerics/registry).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import (
    flash_attention_cuda,
    flash_attention_ref,
    paged_decode_cuda,
    paged_decode_ref,
)
from repro_torch.numerics import kv_pages as _kv
from repro_torch.numerics.registry import get_impl, register_impl

__all__ = ["flash_attention", "paged_decode", "merge_decode_partials"]

register_impl("flash_attention", "cuda", flash_attention_cuda)
register_impl("flash_attention", "ref", flash_attention_ref)
register_impl("paged_decode", "cuda", paged_decode_cuda)
register_impl("paged_decode", "ref", paged_decode_ref)


def merge_decode_partials(o_p: torch.Tensor, m_p: torch.Tensor,
                          l_p: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of split-KV partials.

    o_p: (B, H, hd, n_chunks) f32; m_p, l_p: (B, H, n_chunks) f32.
    Returns (B, H, hd) f32.  All-masked chunks carry (o=0, m=-1e30, l=0)
    and weigh out (their exp(m - m_max) underflows to zero).
    """
    m_max = m_p.amax(dim=-1, keepdim=True)
    w = torch.exp(m_p - m_max)
    l_tot = (l_p * w).sum(dim=-1)
    o = torch.einsum("bhdc,bhc->bhd", o_p, w)
    return o / torch.clamp(l_tot, min=1e-30)[..., None]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Exact attention without materialized scores on the card.

    kv_len: (B,) int32 valid-prefix length (None = all of T).
    Returns (B, Sq, H, hd) in q's dtype.
    """
    impl = get_impl("flash_attention", q.device)
    return impl(q, k, v, kv_len, causal=causal)


def paged_decode(q: torch.Tensor, kv_layer: "_kv.PagedKV",
                 block_tab: torch.Tensor, kv_len: torch.Tensor, *,
                 page_size: int) -> torch.Tensor:
    """One-token attention over one layer's paged pool.

    q: (B, H, hd); block_tab: (B, n_pmax) int32; kv_len: (B,) int32.
    Returns (B, H, hd) f32.
    """
    fmt = _kv.kv_format_of(kv_layer)
    if fmt.is_residue:
        k_raw = kv_layer.k.planes.select(-3, 0)
        v_raw = kv_layer.v.planes.select(-3, 0)
        k_scale, v_scale = kv_layer.k.scale, kv_layer.v.scale
        pack = fmt.pack
    else:
        k_raw, v_raw = kv_layer.k, kv_layer.v
        k_scale = v_scale = pack = None
    impl = get_impl("paged_decode", q.device)
    o_p, m_p, l_p = impl(q.contiguous(), k_raw, v_raw, k_scale, v_scale,
                         block_tab.to(torch.int32).contiguous(),
                         kv_len.to(torch.int32).contiguous(), page_size,
                         pack)
    return merge_decode_partials(o_p, m_p, l_p)
