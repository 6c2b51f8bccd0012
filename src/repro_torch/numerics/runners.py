"""Kernel runners behind the typed numerics API (single device).

* :func:`rns_run` -- activation forward conversion, K segmentation and the
  channel-wise modular matmul over pre-encoded residue planes, then the
  per-segment reverse conversion.  Segments are strided views of the
  operands, so nothing is padded or copied per call (the reference pads
  both operands into fresh tile-aligned buffers on every call).  A stack
  of S matmuls (the MoE expert einsums) runs as one: one forward
  conversion, one kernel launch a K segment and one reverse conversion
  over the whole stack (the reference scans the runner over the slices).
* :func:`sdrns_run` -- the signed-digit sibling over pre-encoded digit
  planes: decode shapes (M <= :data:`DECODE_M`, or the ``sd_matvec`` tag)
  go to the matvec schedule (kernel B7), the rest to the tiled matmul (B6).
  Segments follow the dynamic range alone: the kernels materialize no
  partial-product stack, so the reference's VMEM cap on the segment length
  does not apply (one segment per matmul at int4 on P21 for K <= 21398; the
  int32 totals are the same, each segment decoding exactly).
* :func:`sd_add_run` -- batched carry-free SD addition (kernel B8).
* :func:`encode_rns_planes` / :func:`encode_packed_planes` /
  :func:`encode_sd_planes` -- the plane encoders (elementwise, so
  encode-then-slice equals slice-then-encode).

The sharded paths of the reference wait for the multi-GPU slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import sd, sdrns
from repro_torch.core.moduli import ModuliSet
from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref
from repro_torch.kernels.sd_add import sd_add_cuda, sd_add_ref
from repro_torch.kernels.sdrns_matmul import (sdrns_matmul_cuda,
                                              sdrns_matmul_ref,
                                              sdrns_matvec_cuda)
from repro_torch.numerics.registry import get_impl, register_impl
from repro_torch.numerics.tensor import _digit_width

__all__ = ["DECODE_M", "segment_count", "rns_segments", "sdrns_segments",
           "encode_rns_planes", "encode_packed_planes", "encode_sd_planes",
           "rns_run", "sdrns_run", "sd_add_run"]

register_impl("rns_matmul", "cuda", rns_matmul_cuda)
register_impl("rns_matmul", "ref", rns_matmul_ref)
register_impl("sdrns_matmul", "cuda", sdrns_matmul_cuda)
register_impl("sdrns_matmul", "ref", sdrns_matmul_ref)
register_impl("sdrns_matvec", "cuda", sdrns_matvec_cuda)
register_impl("sdrns_matvec", "ref", sdrns_matmul_ref)
register_impl("sd_add", "cuda", sd_add_cuda)
register_impl("sd_add", "ref", sd_add_ref)

# At or below this M the sd path takes the matvec schedule (kernel B7).
DECODE_M = 8
# int32 elements of the transient an sd plane encode holds per column block
_ENCODE_BLOCK = 1 << 26


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


def segment_count(K: int, max_abs_a: int, max_abs_b: int,
                  mset: ModuliSet) -> int:
    """Segments needed so each exact partial result fits (-M/2, M/2)."""
    if max_abs_a == 0 or max_abs_b == 0:
        return 1
    per_term = max_abs_a * max_abs_b
    cap = mset.half_range // per_term
    if cap < 1:
        raise ValueError(
            f"operand bound {per_term} exceeds dynamic range of {mset.moduli}")
    return max((K + cap - 1) // cap, 1)


def rns_segments(K: int, max_abs_a: int, max_abs_b: int,
                 mset: ModuliSet) -> list[tuple[int, int]]:
    """The K segments :func:`rns_run` cuts a matmul into (one kernel launch
    each): as few as the dynamic range allows, ``seg_len`` rounded up to
    128 terms as the reference rounds it."""
    segs = segment_count(K, max_abs_a, max_abs_b, mset)
    seg_len = _round_up((K + segs - 1) // segs, 128)
    return [(lo, min(lo + seg_len, K)) for lo in range(0, K, seg_len)]


def sdrns_segments(K: int, max_abs_a: int, max_abs_b: int,
                   mset: ModuliSet) -> list[tuple[int, int]]:
    """The K segments :func:`sdrns_run` cuts a matmul into: the dynamic
    range's count, not rounded (the SD kernels hold no partial-product
    stack)."""
    segs = segment_count(K, max_abs_a, max_abs_b, mset)
    seg_len = (K + segs - 1) // segs
    return [(lo, min(lo + seg_len, K)) for lo in range(0, K, seg_len)]


def _res_dtype(mset: ModuliSet) -> torch.dtype:
    """int8 where every centered residue keeps its value mod m in a byte:
    moduli up to 256 (256's +128 wraps to -128, the same residue).  A
    257 channel's +128 would wrap to -128, 255 away, so P24 takes int32
    (the reference stores it as int8 and is off by 255 * 256 * 128 there)."""
    return torch.int8 if max(mset.moduli) <= 256 else torch.int32


def encode_rns_planes(w: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """Integer values (..., K, N) -> centered residue planes (..., C, K, N).

    Channel by channel into the narrow planes, so the transient is one int32
    channel rather than all C (the tied logits weight of qwen3-8b is
    4096 x 151936), centred without a boolean-mask index (whose int64
    indices would be three times the channel: 4.4 GB for a moonshot expert
    stack).
    """
    w = w.to(torch.int32)
    out = torch.empty((*w.shape[:-2], mset.num_channels, *w.shape[-2:]),
                      dtype=_res_dtype(mset), device=w.device)
    for c, m in enumerate(mset.moduli):
        r = torch.remainder(w, m)
        r.sub_((r > m // 2).to(torch.int32).mul_(m))     # centered
        out.select(-3, c).copy_(r)
        del r
    return out


def encode_packed_planes(w: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """Integer values (..., K, N) -> bit-packed planes (..., 1 + r, K, N/vpb).

    Lane 0 packs the two information residues; a redundant set appends its
    ``r`` witness lanes (canonical residues, uint8, one value per byte).
    """
    fmt = mset.packed()
    lane0 = fmt.encode(w)
    if mset.redundant == 0:
        return lane0.unsqueeze(-3)
    if fmt.values_per_byte != 1:
        raise ValueError(f"redundant rns_pack needs one value per byte, got "
                         f"vpb={fmt.values_per_byte} for {mset.moduli}")
    w32 = w.to(torch.int32)
    red = [torch.remainder(w32, m).to(torch.uint8)
           for m in mset.redundant_moduli]
    return torch.stack([lane0, *red], dim=-3)


def rns_run(a: torch.Tensor, b_res: torch.Tensor, *, mset: ModuliSet,
            max_abs_a: int, max_abs_b: int,
            verify: bool = True) -> torch.Tensor:
    """(M, K) integer activation x (C, K, N) planes -> exact (M, N) int32;
    a stack (S, M, K) x (S, C, K, N) -> (S, M, N), every slice equal to a
    run of its own.

    Segment boundaries follow the reference exactly (``seg_len`` rounded up
    to 128; the same for every slice of a stack), so the result is
    bit-identical even where a bound is tight.

    ``verify``: a redundant set's witness channels ride through the kernel
    (channels are independent) and each segment decodes with
    :meth:`ModuliSet.corrected_decode`, so a corrupted weight-plane channel
    never reaches the value domain.  The check runs when ``verify`` is set
    and the set has two or more witness channels (enough to locate one
    fault); ``False`` decodes the information channels unchecked.
    """
    stacked = a.dim() == 3
    if a.dim() not in (2, 3) or b_res.dim() != a.dim() + 1:
        raise ValueError(f"rns_run takes (M, K) x (C, K, N) or (S, M, K) x "
                         f"(S, C, K, N), got {tuple(a.shape)} x "
                         f"{tuple(b_res.shape)}")
    K, K2 = a.shape[-1], b_res.shape[-2]
    if K != K2 or (stacked and a.shape[0] != b_res.shape[0]):
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b_res.shape)}")
    if a.device != b_res.device:
        raise ValueError(f"activation on {a.device}, planes on "
                         f"{b_res.device}")
    impl = get_impl("rns_matmul", a.device)
    decode = mset.corrected_decode if (verify and mset.redundant >= 2) \
        else mset.from_residues
    # (C, [S,] M, K); a stack is seen as (S, C, M, K), not copied
    a_res = mset.to_residues(a.to(torch.int32)).to(_res_dtype(mset))
    if stacked:
        a_res = a_res.movedim(0, 1)
    total = None
    for lo, hi in rns_segments(K, max_abs_a, max_abs_b, mset):
        out_res = impl(a_res[..., lo:hi], b_res[..., lo:hi, :], mset.moduli)
        part = decode(out_res.movedim(-3, 0))
        total = part if total is None else total + part
    return total


def encode_sd_planes(w: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """Integer values (..., K, N) -> SD digit planes (..., C, K, N, n) int8.

    Centered residues per channel, each an n-digit SD vector.  Written
    channel by channel and column block by column block into the int8
    planes: the transient is one block's int32 digits, not the whole
    ``(C, K, N, n)`` (52 GB as int32 for qwen3-8b's tied logits weight).
    """
    n = _digit_width(mset)
    w = w.to(torch.int32)
    K, N = w.shape[-2:]
    out = torch.empty((*w.shape[:-2], mset.num_channels, K, N, n),
                      dtype=torch.int8, device=w.device)
    rows = max(1, w[..., 0].numel())
    cols = max(1, _ENCODE_BLOCK // (rows * n))
    for c, m in enumerate(mset.moduli):
        for j0 in range(0, N, cols):
            r = torch.remainder(w[..., j0:j0 + cols], m)
            r = torch.where(r > m // 2, r - m, r)
            out.select(-4, c)[..., j0:j0 + cols, :].copy_(sd.from_int(r, n))
    return out


def sdrns_run(a: torch.Tensor, b_dig: torch.Tensor, *, mset: ModuliSet,
              max_abs_a: int, max_abs_b: int,
              force_matvec: bool = False) -> torch.Tensor:
    """(M, K) integer activation x (C, K, N, n) digit planes -> exact (M, N)
    int32.

    The activation's centered residues become SD digits, each K segment's
    digit product decodes exactly (``sdrns_decode``), and the segments sum.
    ``force_matvec`` (the ``sd_matvec`` layout) pins the matvec schedule;
    it takes M in row blocks of :data:`DECODE_M`.
    """
    n = _digit_width(mset)
    M, K = a.shape
    C, K2, N, n2 = b_dig.shape
    if (K, n) != (K2, n2) or C != mset.num_channels:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x "
                         f"{tuple(b_dig.shape)} on {mset.moduli}")
    if a.device != b_dig.device:
        raise ValueError(f"activation on {a.device}, planes on "
                         f"{b_dig.device}")
    matvec = force_matvec or M <= DECODE_M
    impl = get_impl("sdrns_matvec" if matvec else "sdrns_matmul", a.device)
    ws = [sdrns.WRAP_SIGNS[kind] for kind, _ in mset.kinds]
    a_dig = sd.from_int(mset.to_residues(a.to(torch.int32)), n)
    rows = DECODE_M if matvec else M
    total = None
    for lo, hi in sdrns_segments(K, max_abs_a, max_abs_b, mset):
        outs = [impl(a_dig[:, r:r + rows, lo:hi], b_dig[:, lo:hi], ws)
                for r in range(0, M, rows)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        part = sdrns.sdrns_decode(out, mset)
        total = part if total is None else total + part
    return total


def sd_add_run(x: torch.Tensor, y: torch.Tensor, *, kind: str
               ) -> torch.Tensor:
    """Batched carry-free SD addition of (..., n) int8 digit tensors;
    (..., n + 1) out for ``kind="plain"``."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    return get_impl("sd_add", x.device)(x.to(torch.int8), y.to(torch.int8),
                                        kind)
