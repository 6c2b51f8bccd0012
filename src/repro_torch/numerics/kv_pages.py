"""Paged KV-cache storage: fixed-size pages, dense or residue-domain.

One page holds ``page_size`` consecutive positions of one layer's K (or V);
a request owns an ordered list of page ids (its block-table row) and writes
position ``pos`` into page ``tab[pos // ps]`` at offset ``pos % ps``.

* dense pages: ``(L, P, ps, Kv, hd)`` tensors in the cache dtype (bf16);
* residue pages: each value quantized symmetrically per (token, head) along
  ``hd``, carried as centered residues of a packable 2-channel set and
  bit-packed into uint8 planes ``(L, P, ps, 1 + r, Kv, hd/vpb)`` (the
  ``rns_pack`` layout of :class:`ResidueTensor`), plus one f32 scale per
  (page, slot, head).  ``rns8`` = (15, 16), one byte per value; ``rns4`` =
  (3, 4), one nibble per value; ``rns8r`` = (15, 16 | 17, 19), the rns8
  byte in lane 0 plus two witness lanes, so any single corrupted lane of a
  value (the packed byte included) is detected and rebuilt
  (:func:`verify_pages`, :func:`repair_pages`).

Unlike the reference, whose arrays are immutable, the writes here
(:func:`append_token`, :func:`scatter_prefill`, :func:`verify_pages`,
:func:`repair_pages`) update the pool in place:
the pool is the largest mutable state of a serving step and is never
copied.  :func:`layer_slice` returns views.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.moduli import KV4, KV8, KV8R2, ModuliSet, PackedFormat
from repro_torch.numerics.runners import encode_packed_planes
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.quant import true_divide

__all__ = ["KVFormat", "KV_FORMATS", "PagedKV", "kv_format_of",
           "make_paged_kv", "quantize_to_format", "append_token",
           "scatter_prefill", "layer_slice", "layer_update", "pool_bytes",
           "verify_pages", "repair_pages", "bytes_per_token"]


@dataclasses.dataclass(frozen=True)
class KVFormat:
    """How KV pages are stored (``mset is None``: dense cache-dtype pages)."""

    name: str
    mset: ModuliSet | None = None

    @property
    def is_residue(self) -> bool:
        return self.mset is not None

    @property
    def qmax(self) -> int:
        """Largest quantized magnitude inside the centered range."""
        return (self.mset.M - 2) // 2

    @property
    def qbits(self) -> int:
        return int(self.qmax).bit_length()

    @property
    def pack(self) -> PackedFormat:
        return self.mset.packed()

    @property
    def redundant(self) -> int:
        return 0 if self.mset is None else self.mset.redundant


KV_FORMATS: dict[str, KVFormat] = {
    "bf16": KVFormat("bf16"),
    "rns8": KVFormat("rns8", KV8),
    "rns4": KVFormat("rns4", KV4),
    "rns8r": KVFormat("rns8r", KV8R2),
}


class PagedKV(NamedTuple):
    """K and V page pools: tensors (dense) or ResidueTensors (residue)."""

    k: torch.Tensor | ResidueTensor
    v: torch.Tensor | ResidueTensor


def kv_format_of(paged: PagedKV) -> KVFormat:
    if isinstance(paged.k, ResidueTensor):
        for fmt in KV_FORMATS.values():
            if fmt.mset is not None and fmt.mset.moduli == paged.k.mset.moduli:
                return fmt
        raise ValueError(f"no KV format for moduli {paged.k.mset.moduli}")
    return KV_FORMATS["bf16"]


def _residue_pool(fmt: KVFormat, shape: tuple[int, ...],
                  device) -> ResidueTensor:
    """Zero pages (scales 1, so untouched pages decode to exact zeros)."""
    vpb = fmt.pack.values_per_byte
    *lead, kv, hd = shape
    if hd % vpb:
        raise ValueError(
            f"head_dim {hd} not divisible by packing factor {vpb}")
    planes = torch.zeros((*lead, 1 + fmt.redundant, kv, hd // vpb),
                         dtype=torch.uint8, device=device)
    scale = torch.ones((*lead, kv, 1), dtype=torch.float32, device=device)
    return ResidueTensor(planes, scale, fmt.mset, layout="rns_pack",
                         qbits=fmt.qbits)


def make_paged_kv(n_layers: int, num_pages: int, page_size: int, n_kv: int,
                  head_dim: int, *, fmt: KVFormat | str = "bf16",
                  dtype=torch.bfloat16, device="cuda") -> PagedKV:
    """An all-zeros pool ``(L, P, ps, Kv, hd)`` for K and V."""
    if isinstance(fmt, str):
        fmt = KV_FORMATS[fmt]
    shape = (n_layers, num_pages, page_size, n_kv, head_dim)
    if fmt.is_residue:
        return PagedKV(_residue_pool(fmt, shape, device),
                       _residue_pool(fmt, shape, device))
    return PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def quantize_to_format(x: torch.Tensor, fmt: KVFormat
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (..., Kv, hd)`` -> packed planes ``(..., 1 + r, Kv, hd/vpb)`` uint8
    (witness lanes after the packed one) and scales ``(..., Kv, 1)`` f32
    (symmetric, per (token, head))."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = true_divide(torch.clamp(amax, min=1e-8), fmt.qmax)
    q = torch.round_(x / scale).clamp_(-fmt.qmax, fmt.qmax)
    return encode_packed_planes(q.to(torch.int32), fmt.mset), scale


def _check_packed(planes: torch.Tensor, mset: ModuliSet):
    """Syndrome-check and repair redundant ``rns_pack`` planes elementwise.

    ``planes (..., 1 + r, Kv, hd)`` uint8.  A flipped witness perturbs one
    syndrome: the witness is rewritten from the packed decode.  A flipped
    packed byte corrupts both information residues, so every syndrome
    fires: the value is rebuilt from the witnesses alone (their product
    exceeds the range) and lane 0 re-encoded.  Returns ``(fixed, detected,
    corrected)``, the masks over the lane-collapsed shape; ``detected &
    ~corrected`` marks a double fault the code cannot repair.
    """
    fmt = mset.packed()
    lanes = planes.movedim(-3, 0).to(torch.int32)
    x = fmt.decode(lanes[0])
    red_m = mset.redundant_moduli
    syn = [torch.remainder(lanes[1 + j] - torch.remainder(x, m), m) != 0
           for j, m in enumerate(red_m)]
    n_nz = sum(s.to(torch.int32) for s in syn)
    detected = n_nz > 0
    witness_fault = n_nz == 1
    byte_fault = torch.zeros_like(detected)
    x_fixed = x
    if len(red_m) >= 2:
        x_w = ModuliSet.make(red_m).from_residues(lanes[1:1 + len(red_m)])
        byte_fault = (n_nz >= 2) & (x_w.abs() <= mset.half_range)
        x_fixed = torch.where(byte_fault, x_w, x)
    out = [torch.where(byte_fault, fmt.encode(x_fixed).to(torch.int32),
                       lanes[0])]
    for j, m in enumerate(red_m):
        out.append(torch.where(witness_fault & syn[j],
                               torch.remainder(x, m), lanes[1 + j]))
    fixed = torch.stack(out, dim=0).movedim(0, -3).to(torch.uint8)
    return fixed, detected, witness_fault | byte_fault


def verify_pages(t: ResidueTensor, *, sync: bool = True):
    """Verify and repair a whole redundant page pool, in place.

    Returns ``(t, detected, corrected)`` element counts: host ints, or with
    ``sync=False`` 0-d device tensors read later (the engine's overlapped
    scrub).  Pools without redundancy return unchanged with zero counts.
    The f32 scales are not residue-coded and not covered.
    """
    if not isinstance(t, ResidueTensor) or t.layout != "rns_pack":
        raise TypeError("verify_pages expects an rns_pack ResidueTensor")
    if t.mset.redundant == 0:
        zero = torch.zeros((), dtype=torch.int64, device=t.planes.device)
        return (t, 0, 0) if sync else (t, zero, zero)
    fixed, det, cor = _check_packed(t.planes, t.mset)
    t.planes.copy_(fixed)
    det, cor = det.sum(), cor.sum()
    return (t, int(det), int(cor)) if sync else (t, det, cor)


def repair_pages(t: ResidueTensor, layers, pages):
    """Verify and repair the ``layers x pages`` rectangle of a redundant
    pool, in place: the escalation path after a nonzero in-kernel syndrome.

    Returns ``(t, detected, corrected, uncorrectable)``, the counts as host
    ``(len(layers), len(pages))`` int arrays: the per-page fault ledger the
    engine's quarantine policy reads.
    """
    if not isinstance(t, ResidueTensor) or t.layout != "rns_pack":
        raise TypeError("repair_pages expects an rns_pack ResidueTensor")
    if t.mset.redundant == 0:
        raise ValueError("repair_pages needs a redundant moduli set")
    dev = t.planes.device
    li = torch.as_tensor(list(layers), dtype=torch.long, device=dev)[:, None]
    pi = torch.as_tensor(list(pages), dtype=torch.long, device=dev)[None, :]
    fixed, det, cor = _check_packed(t.planes[li, pi], t.mset)
    t.planes[li, pi] = fixed
    axes = tuple(range(2, det.dim()))
    unc = det & ~cor
    counts = [c.sum(axes).to(torch.int32).cpu().numpy()
              for c in (det, cor, unc)]
    return (t, *counts)


def append_token(kv_layer: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                 pages: torch.Tensor, offs: torch.Tensor) -> PagedKV:
    """Write one token per slot into one layer's pool, in place.

    ``k_new``/``v_new``: (B, Kv, hd) in the cache dtype; ``pages``/``offs``:
    (B,) int positions in the pool.
    """
    fmt = kv_format_of(kv_layer)
    pages, offs = pages.long(), offs.long()

    def put(pool, new):
        if fmt.is_residue:
            planes, scale = quantize_to_format(new, fmt)
            pool.planes[pages, offs] = planes
            pool.scale[pages, offs] = scale
        else:
            pool[pages, offs] = new.to(pool.dtype)

    put(kv_layer.k, k_new)
    put(kv_layer.v, v_new)
    return kv_layer


def scatter_prefill(paged: PagedKV, k_dense: torch.Tensor,
                    v_dense: torch.Tensor, tab: torch.Tensor,
                    page_size: int) -> PagedKV:
    """Scatter a dense prefill cache ``(L, B, S, Kv, hd)`` into the pool.

    ``tab (B, n_pmax)`` maps each request's page index to a pool page;
    ``S`` is zero-padded to ``n_pmax * page_size`` first, and entries past
    the prompt point at the dump page.  In place.
    """
    fmt = kv_format_of(paged)
    n_pmax = tab.shape[1]
    want = n_pmax * page_size
    tab = tab.long()

    def put(pool, dense):
        pad = want - dense.shape[2]
        if pad < 0:
            raise ValueError(f"prefill length {dense.shape[2]} exceeds "
                             f"block table capacity {want}")
        if pad:
            dense = torch.nn.functional.pad(dense, (0, 0, 0, 0, 0, pad))
        tiles = dense.reshape(dense.shape[0], dense.shape[1], n_pmax,
                              page_size, *dense.shape[3:])
        if fmt.is_residue:
            planes, scale = quantize_to_format(tiles, fmt)
            pool.planes[:, tab] = planes
            pool.scale[:, tab] = scale
        else:
            pool[:, tab] = tiles.to(pool.dtype)

    put(paged.k, k_dense)
    put(paged.v, v_dense)
    return paged


def _leaf_slice(leaf, i: int):
    if isinstance(leaf, ResidueTensor):
        return dataclasses.replace(leaf, planes=leaf.planes[i],
                                   scale=leaf.scale[i])
    return leaf[i]


def layer_slice(paged: PagedKV, i: int) -> PagedKV:
    """Layer ``i`` of the stacked pool, as views."""
    return PagedKV(_leaf_slice(paged.k, i), _leaf_slice(paged.v, i))


def layer_update(paged: PagedKV, i: int, layer_kv: PagedKV) -> PagedKV:
    """Write a per-layer pool back at layer ``i`` (a no-op for the views
    :func:`layer_slice` returned, which were updated in place)."""
    def put(stack, lay):
        pairs = ([(stack.planes[i], lay.planes), (stack.scale[i], lay.scale)]
                 if isinstance(stack, ResidueTensor) else [(stack[i], lay)])
        for dst, src in pairs:
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    put(paged.k, layer_kv.k)
    put(paged.v, layer_kv.v)
    return paged


def bytes_per_token(fmt: KVFormat | str, n_kv: int, head_dim: int,
                    dtype=torch.bfloat16) -> int:
    """KV bytes one resident token occupies (K and V, one layer)."""
    if isinstance(fmt, str):
        fmt = KV_FORMATS[fmt]
    if fmt.is_residue:
        vpb = fmt.pack.values_per_byte
        plane_bytes = n_kv * (head_dim // vpb + fmt.redundant * head_dim)
        return 2 * (plane_bytes + n_kv * 4)
    return 2 * n_kv * head_dim * torch.empty((), dtype=dtype).element_size()


def pool_bytes(paged: PagedKV) -> int:
    """Bytes held by the pool's device tensors."""
    total = 0
    for leaf in paged:
        if isinstance(leaf, ResidueTensor):
            total += leaf.nbytes()
        else:
            total += leaf.numel() * leaf.element_size()
    return total
