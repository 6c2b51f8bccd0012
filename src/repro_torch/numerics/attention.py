"""Attention ops behind the numerics registry.

* :func:`flash_attention` -- GQA-native causal attention over the model
  layouts ``q (B, Sq, H, hd)`` / ``k, v (B, T, Kv, hd)`` (prefill).
* :func:`flash_decode` -- one-token split-KV attention over one layer's
  dense contiguous cache ``(B, T, Kv, hd)``: one ``(o, m, l)`` partial per
  chunk of ``bk`` rows, ``bk = pick_block(T, 512)`` unless
  :func:`set_decode_block` overrides it;
* :func:`paged_decode` -- one-token split-KV attention over one layer's
  paged pool: the kernel emits one ``(o, m, l)`` partial per block-table
  entry; on rns8r pages it can also count witness mismatches in the same
  pass (``syndrome=True``).

* :func:`paged_verify` -- the speculative verify's V rows a slot over the
  paged pool: the V axis folded into the paged decode's batch, one launch.

The decodes combine their partials with :func:`merge_decode_partials`.

The implementation follows the device of ``q`` (numerics/registry).

Under an installed :class:`~repro_torch.parallel.sharding.ShardCtx`,
:func:`flash_attention` and :func:`flash_decode` run their kernel on this
rank's batch rows over ``dp`` (when B divides) and all-gather the rows, so
attention is replicated over ``tp`` and every rank holds the whole output
(:func:`_batch_plan`, the counterpart of the reference's
``_channel_ctx_plan``).  The port does this under both plane layouts: the
reference sends its column layout to materialized attention for the sake
of its partitioner's layouts, which the port does not have.  The paged
decode runs as it is: serving engines take the dense cache under a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import (
    flash_attention_cuda,
    flash_attention_meta,
    flash_attention_ref,
    flash_decode_cuda,
    flash_decode_meta,
    flash_decode_ref,
    paged_decode_cuda,
    paged_decode_meta,
    paged_decode_ref,
)
from repro_torch.numerics import kv_pages as _kv
from repro_torch.numerics.registry import get_impl, register_impl
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as _sh

__all__ = ["flash_attention", "flash_decode", "paged_decode", "paged_verify",
           "merge_decode_partials", "pick_block", "set_decode_block"]

DEFAULT_DECODE_BLOCK = 512     # the reference's DEFAULT_BLOCKS[1]

register_impl("flash_attention", "cuda", flash_attention_cuda)
register_impl("flash_attention", "ref", flash_attention_ref)
register_impl("flash_decode", "cuda", flash_decode_cuda)
register_impl("flash_decode", "ref", flash_decode_ref)
register_impl("paged_decode", "cuda", paged_decode_cuda)
register_impl("paged_decode", "ref", paged_decode_ref)
register_impl("flash_attention", "meta", flash_attention_meta)
register_impl("flash_decode", "meta", flash_decode_meta)
register_impl("paged_decode", "meta", paged_decode_meta)


def pick_block(n: int, pref: int) -> int:
    """Preferred tile size, shrunk (8-aligned) when the dim is smaller."""
    return min(pref, -(-max(n, 1) // 8) * 8)


_DECODE_BLOCK_OVERRIDE: int | None = None


def set_decode_block(bk: int | None) -> int | None:
    """Override the dense split-KV decode chunk size (None restores auto).

    With the chunk equal to the page size the dense decode emits the paged
    decode's partials over the same rows and runs the same merge, so the
    two are bit-identical.  Returns the previous override.
    """
    global _DECODE_BLOCK_OVERRIDE
    prev = _DECODE_BLOCK_OVERRIDE
    _DECODE_BLOCK_OVERRIDE = bk
    return prev


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


def _batch_plan(B: int):
    """``(mesh, dp)`` when a shard context splits the batch over dp (B
    divides), else None: the kernel then runs on every rank's whole
    batch (under ``rows_local`` the batch is this rank's rows already)."""
    ctx = _sh.get_shard_ctx()
    if ctx is None or ctx.rows_local:
        return None
    dp = ctx.resolve("dp")
    if not dp or ctx.axis_size(dp) <= 1 or B % ctx.axis_size(dp):
        return None
    return ctx.mesh, dp


def _per_rows(plan, fn, *batched):
    """``fn`` on this rank's batch rows of each tensor (None passes), the
    output's rows gathered over dp."""
    if plan is None:
        return fn(*batched)
    mesh, dp = plan
    local = [None if x is None else collectives.block_of(x, 0, mesh, dp)
             for x in batched]
    return collectives.all_gather(fn(*local), 0, mesh, dp)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Exact attention without materialized scores on the card.

    kv_len: (B,) int32 valid-prefix length (None = all of T).
    Returns (B, Sq, H, hd) in q's dtype.
    """
    impl = get_impl("flash_attention", q.device)
    return _per_rows(_batch_plan(q.shape[0]),
                     lambda q_, k_, v_, len_: impl(
                         q_.contiguous(), k_.contiguous(), v_.contiguous(),
                         len_, causal=causal),
                     q, k, v, kv_len)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len: torch.Tensor | int, bk: int | None = None
                 ) -> torch.Tensor:
    """One-token split-KV attention over a (padded) dense KV cache.

    q: (B, H, hd); k, v: (B, T, Kv, hd) contiguous; kv_len: (B,) valid
    prefix lengths, or one length for every slot as an int.  Returns
    (B, H, hd) f32 (callers cast at the boundary).
    """
    B = q.shape[0]
    T = k.shape[1]
    bk = bk or _DECODE_BLOCK_OVERRIDE or pick_block(T, DEFAULT_DECODE_BLOCK)
    # a meta tensor holds no values: in a dry run the lengths stay on the
    # host, where the work count reads them
    dev = "cpu" if q.is_meta else q.device
    if isinstance(kv_len, int):                 # no host copy, no sync
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
    else:
        kv_len = torch.as_tensor(kv_len, device=dev).to(
            torch.int32).expand(B).contiguous()
    impl = get_impl("flash_decode", q.device)
    return _per_rows(_batch_plan(B),
                     lambda q_, k_, v_, len_: merge_decode_partials(*impl(
                         q_.contiguous(), k_.contiguous(), v_.contiguous(),
                         len_.contiguous(), bk)),
                     q, k, v, kv_len)


def paged_decode(q: torch.Tensor, kv_layer: "_kv.PagedKV",
                 block_tab: torch.Tensor, kv_len: torch.Tensor, *,
                 page_size: int, syndrome: bool = False):
    """One-token attention over one layer's paged pool.

    q: (B, H, hd); block_tab: (B, n_pmax) int32; kv_len: (B,) int32.
    Returns (B, H, hd) f32.  Residue pages are read through lane 0 of the
    pool in place; the witness lanes of a redundant format reach the kernel
    only with ``syndrome=True``, which then also returns the (B,) int32
    count of valid KV elements whose witnesses disagree: ``(out, syn)``.
    """
    fmt = _kv.kv_format_of(kv_layer)
    if syndrome and not (fmt.is_residue and fmt.redundant):
        raise ValueError(f"syndrome=True requires a redundant residue KV "
                         f"format (e.g. 'rns8r'); got {fmt.name!r}")
    wit = {}
    if fmt.is_residue:
        k_raw = kv_layer.k.planes.select(-3, 0)
        v_raw = kv_layer.v.planes.select(-3, 0)
        k_scale, v_scale = kv_layer.k.scale, kv_layer.v.scale
        pack = fmt.pack
        if syndrome:
            r = fmt.redundant
            wit = dict(k_wit=kv_layer.k.planes.narrow(-3, 1, r),
                       v_wit=kv_layer.v.planes.narrow(-3, 1, r),
                       red_moduli=fmt.mset.redundant_moduli)
    else:
        k_raw, v_raw = kv_layer.k, kv_layer.v
        k_scale = v_scale = pack = None
    impl = get_impl("paged_decode", q.device)
    parts = impl(q.contiguous(), k_raw, v_raw, k_scale, v_scale,
                 block_tab.to(torch.int32).contiguous(),
                 kv_len.to(torch.int32).contiguous(), page_size, pack, **wit)
    out = merge_decode_partials(*parts[:3])
    if syndrome:
        # nonzero only on GQA lead heads: the sum counts each element once
        return out, parts[3].sum(dim=(1, 2), dtype=torch.int32)
    return out


def paged_verify(q: torch.Tensor, kv_layer: "_kv.PagedKV",
                 block_tab: torch.Tensor, kv_len: torch.Tensor, *,
                 page_size: int) -> torch.Tensor:
    """Multi-token attention over one layer's paged pool (the speculative
    verify step).

    q: (B, V, H, hd); block_tab: (B, n_pmax); kv_len: (B, V) per-row valid
    lengths.  Row ``(b, j)`` becomes row ``b * V + j`` of one
    :func:`paged_decode` with its slot's block-table row repeated and its
    own ``kv_len``, so every row runs the one-token kernel's arithmetic on
    its own prefix: one launch, no new kernel.  Returns (B, V, H, hd) f32.
    """
    B, V, H, hd = q.shape
    tab = torch.repeat_interleave(block_tab, V, dim=0)
    out = paged_decode(q.reshape(B * V, H, hd), kv_layer, tab,
                       kv_len.reshape(B * V), page_size=page_size)
    return out.reshape(B, V, H, hd)
