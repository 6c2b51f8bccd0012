"""Yardstick of the latent-attention MoE decoder (Moonlight-16B-A3B): its
model FLOPs, and B2's work where q and k are wider than v.

* Model FLOPs (the classic convention, as ``flops.py``): 2 a parameter a
  token of the parameters a token uses: each layer's attention
  projections (``wq``, ``kv_a``, ``kv_b``, ``wo``), the leading dense
  layers' SwiGLU, and in each expert layer the router, the ``top_k``
  routed experts and the shared experts; the untied head once a logits
  row.
* :func:`attention_work_split`: B2 with q and k of ``dk`` values a head and
  v of ``dv``: 2 dk operations a (query head, key) pair for the scores and
  2 dv for the product with v; q, k, v and the output read or written
  once.  At ``dk == dv`` it equals ``work.attention_work`` (which counts
  ``4 hd`` operations and the v and output bytes at q's width, so it
  counts unequal widths wrong).
"""
from __future__ import annotations

from typing import Sequence

from yardstick import work


def _attn_params(cfg: dict) -> int:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    return (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv)
            + H * dv * d)


def active_layer_params(cfg: dict, i: int) -> int:
    """Parameters a token uses in layer ``i``."""
    d = cfg["hidden_size"]
    if i < cfg["first_k_dense_replace"]:
        return _attn_params(cfg) + 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    return (_attn_params(cfg) + d * E + k * 3 * d * f
            + 3 * d * cfg["n_shared_experts"] * f)


def decoder_flops(cfg: dict, tokens: int, logit_rows: int) -> float:
    """Model FLOPs of ``tokens`` prompt tokens and ``logit_rows`` rows of
    logits (``cfg`` holds the published keys)."""
    layers = sum(active_layer_params(cfg, i)
                 for i in range(cfg["num_hidden_layers"]))
    return (2.0 * layers * tokens
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * logit_rows)


def attention_work_split(B: int, Sq: int, H: int, Kv: int, dk: int, dv: int,
                         lengths: Sequence[int], *, causal: bool, esz: int,
                         kind: str, with_len: bool) -> work.Work:
    """B2's work with q and k of ``dk`` and v and the output of ``dv``
    values a head (module docstring)."""
    pairs = H * sum(work._causal_pairs(Sq, n) if causal else Sq * n
                    for n in lengths)
    nbytes = esz * (B * Sq * H * (dk + dv) + sum(lengths) * Kv * (dk + dv))
    return work.Work(2 * (dk + dv) * pairs,
                     nbytes + (4 * B if with_len else 0), kind)


def flash_attention_split_cost(q, k, v, kv_len=None, *, causal=True,
                               **_) -> work.Work:
    """:func:`attention_work_split` from the registry's arguments (lengths
    read from ``kv_len``'s values, a copy taken at the call)."""
    import torch
    B, Sq, H, dk = q.shape
    T, Kv = k.shape[1], k.shape[2]
    return attention_work_split(
        B, Sq, H, Kv, dk, v.shape[-1],
        work._lengths(work._host(kv_len), B, T), causal=causal,
        esz=q.element_size(),
        kind="bf16" if q.dtype == torch.bfloat16 else "f32",
        with_len=kv_len is not None)
