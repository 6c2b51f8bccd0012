"""Kernel runners behind the typed numerics API (single device).

* :func:`rns_run` -- activation forward conversion, K segmentation and the
  channel-wise modular matmul over pre-encoded residue planes, then the
  per-segment reverse conversion.  Segments are strided views of the
  operands, so nothing is padded or copied per call (the reference pads
  both operands into fresh tile-aligned buffers on every call).
* :func:`encode_rns_planes` / :func:`encode_packed_planes` -- the plane
  encoders (elementwise, so encode-then-slice equals slice-then-encode).

The sharded paths of the reference wait for the multi-GPU slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.moduli import ModuliSet
from repro_torch.kernels.rns_matmul import rns_matmul_cuda, rns_matmul_ref
from repro_torch.numerics.registry import get_impl, register_impl

__all__ = ["segment_count", "encode_rns_planes", "encode_packed_planes",
           "rns_run"]

register_impl("rns_matmul", "cuda", rns_matmul_cuda)
register_impl("rns_matmul", "ref", rns_matmul_ref)


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


def _res_dtype(mset: ModuliSet) -> torch.dtype:
    return torch.int8 if max(mset.moduli) <= 257 else torch.int32


def encode_rns_planes(w: torch.Tensor, mset: ModuliSet) -> torch.Tensor:
    """Integer values (..., K, N) -> centered residue planes (..., C, K, N).

    Channel by channel into the narrow planes, so the transient is one int32
    channel rather than all C (the tied logits weight of qwen3-8b is
    4096 x 151936).
    """
    w = w.to(torch.int32)
    out = torch.empty((*w.shape[:-2], mset.num_channels, *w.shape[-2:]),
                      dtype=_res_dtype(mset), device=w.device)
    for c, m in enumerate(mset.moduli):
        r = torch.remainder(w, m)
        r[r > m // 2] -= m                               # centered
        out.select(-3, c).copy_(r)
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
    """(M, K) integer activation x (C, K, N) planes -> exact (M, N) int32.

    Segment boundaries follow the reference exactly (``seg_len`` rounded up
    to 128), so the result is bit-identical even where a bound is tight.

    ``verify``: a redundant set's witness channels ride through the kernel
    (channels are independent) and each segment decodes with
    :meth:`ModuliSet.corrected_decode`, so a corrupted weight-plane channel
    never reaches the value domain.  The check runs when ``verify`` is set
    and the set has two or more witness channels (enough to locate one
    fault); ``False`` decodes the information channels unchecked.
    """
    M, K = a.shape
    C, K2, N = b_res.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b_res.shape)}")
    if a.device != b_res.device:
        raise ValueError(f"activation on {a.device}, planes on "
                         f"{b_res.device}")
    impl = get_impl("rns_matmul", a.device)
    decode = mset.corrected_decode if (verify and mset.redundant >= 2) \
        else mset.from_residues
    a_res = mset.to_residues(a.to(torch.int32)).to(_res_dtype(mset))
    segs = segment_count(K, max_abs_a, max_abs_b, mset)
    seg_len = _round_up((K + segs - 1) // segs, 128)
    segs = (K + seg_len - 1) // seg_len
    total = None
    for s in range(segs):
        lo, hi = s * seg_len, min((s + 1) * seg_len, K)
        out_res = impl(a_res[:, :, lo:hi], b_res[:, lo:hi, :], mset.moduli)
        part = decode(out_res)
        total = part if total is None else total + part
    return total
