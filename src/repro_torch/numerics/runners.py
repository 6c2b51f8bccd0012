"""Kernel runners behind the typed numerics API (single device).

* :func:`rns_run` -- activation forward conversion, K segmentation and the
  channel-wise modular matmul over pre-encoded residue planes, then the
  per-segment reverse conversion (kernel B9, each segment added into the
  sum in place; the witness check of a redundant set stays eager).
  Segments are strided views of the operands, so nothing is padded or
  copied per call (the reference pads both operands into fresh
  tile-aligned buffers on every call).  A stack
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

Mesh composition
----------------
:func:`tp_shard_plan` turns the installed
:class:`~repro_torch.parallel.sharding.ShardCtx` into a tagged plan, and
:func:`weight_plan` fits it to where a weight's planes sit;
with one, :func:`rns_run` / :func:`sdrns_run` run an explicit per-rank
body (the reference's ``shard_map`` bodies) on the whole activation each
rank holds, taking its rows over ``dp`` when M divides:

* ``("col", mesh, dp, tp)`` -- the default layout: the rank's plane columns
  over ``tp`` (:func:`plan_planes` gathers K where FSDP split it over
  ``dp``); the unchanged kernel runs on them, and the exact int32 columns
  are all-gathered over ``tp``.  Column slices of an exact integer matmul
  commute with the kernel, so the result equals the single-device one bit
  for bit.
* ``("row", mesh, dp, tp)`` -- the default layout's row-parallel weights
  (``wo``, ``w_down``, ``out_proj``: K over ``tp``; :func:`weight_plan`
  picks it from where the planes sit): the kernel runs on the rank's own K
  rows and the matching columns of the activation, each of the matmul's K
  segments cut at the rank's bounds, and the exact int32 partials are
  all-reduced over ``tp``.  Each piece of a segment decodes exactly where
  the segment does, and int32 addition is associative, so the sum equals
  the single-device result bit for bit; no plane leaves its rank (a
  ``"col"`` plan would gather the whole weight on every call).
* ``("chan", mesh, dp, tp)`` -- the ``channel_shard`` layout: the rank's
  moduli channels over ``tp``; the kernel runs on them with their own
  moduli (or wrap signs), each K segment projects to a CRT partial
  (``ModuliSet.partial_decode``, with ``partial_witnesses`` for a
  redundant set), one stacked int32 all-reduce over ``tp`` sums them, and
  each segment folds on its own (``fold_partials`` / ``corrected_fold``;
  folding the sum of segments would be wrong: they are separate exact
  products).  No rank holds every channel, and the decode is bit-identical
  to the gathered one.

The rows are all-gathered over ``dp`` at the end, so every rank returns the
whole ``(M, N)``.  When ``channel_shard`` is asked for and the all-reduce
path cannot run (C does not divide the tensor axis, no moduli set reached
the planner, or a set past the int32 partial-CRT bound), the planner warns
and counts it (:func:`fallback_gather_count`, surfaced as
``EngineStats.fallback_gathers``) and the matmul runs on one device's
layout, the planes gathered whole.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch import tracing
from repro_torch.core import sd, sdrns
from repro_torch.core.moduli import ModuliSet
from repro_torch.kernels import rns_decode
from repro_torch.kernels.rns_matmul import (rns_matmul_cuda, rns_matmul_meta,
                                            rns_matmul_ref)
from repro_torch.kernels.sd_add import sd_add_cuda, sd_add_meta, sd_add_ref
from repro_torch.kernels.sdrns_matmul import (sdrns_matmul_cuda,
                                              sdrns_matmul_meta,
                                              sdrns_matmul_ref,
                                              sdrns_matvec_cuda)
from repro_torch.numerics.registry import get_impl, register_impl
from repro_torch.numerics.tensor import ResidueTensor, _digit_width
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as _sh

__all__ = ["DECODE_M", "segment_count", "rns_segments", "sdrns_segments",
           "encode_rns_planes", "encode_packed_planes", "encode_sd_planes",
           "rns_run", "sdrns_run", "sd_add_run", "tp_shard_plan",
           "weight_plan", "plan_planes", "fallback_gather_count"]

register_impl("rns_matmul", "cuda", rns_matmul_cuda)
register_impl("rns_matmul", "ref", rns_matmul_ref)
register_impl("sdrns_matmul", "cuda", sdrns_matmul_cuda)
register_impl("sdrns_matmul", "ref", sdrns_matmul_ref)
register_impl("sdrns_matvec", "cuda", sdrns_matvec_cuda)
register_impl("sdrns_matvec", "ref", sdrns_matmul_ref)
register_impl("sd_add", "cuda", sd_add_cuda)
register_impl("sd_add", "ref", sd_add_ref)
register_impl("rns_matmul", "meta", rns_matmul_meta)
register_impl("sdrns_matmul", "meta", sdrns_matmul_meta)
register_impl("sdrns_matvec", "meta", sdrns_matmul_meta)
register_impl("sd_add", "meta", sd_add_meta)
register_impl("rns_decode", "cuda", rns_decode.rns_decode_cuda)
register_impl("rns_decode", "ref", rns_decode.rns_decode_ref)
register_impl("rns_decode", "meta", rns_decode.rns_decode_meta)

# At or below this M the sd path takes the matvec schedule (kernel B7).
DECODE_M = 8
# int32 elements of the transient an sd plane encode holds per column block
_ENCODE_BLOCK = 1 << 26


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


# ---------------------------------------------------------------------------
# Mesh composition: plans for the matmul runners.
# ---------------------------------------------------------------------------

# Times channel_shard was asked for and the partial-CRT path could not
# run: counted per plan resolution (every public matmul / einsum resolves
# one), so a mis-sharded mesh shows instead of running quietly slow.
_FALLBACK_GATHERS = 0


def fallback_gather_count() -> int:
    """Process-lifetime count of channel_shard fallbacks."""
    return _FALLBACK_GATHERS


def _fallback(reason: str) -> None:
    global _FALLBACK_GATHERS
    _FALLBACK_GATHERS += 1
    warnings.warn("channel_shard layout fell back to the replicated/"
                  f"gathered decode path: {reason}", UserWarning,
                  stacklevel=4)


def tp_shard_plan(M: int, N: int, *, mset: ModuliSet | None = None):
    """The plan of the installed ShardCtx, or None (one device).

    ``("col", mesh, dp, tp)`` -- plane columns over ``tp`` (needs ``N %
    tp_size == 0``); ``("chan", mesh, dp, tp)`` -- under ``channel_shard``,
    moduli channels over ``tp`` (needs ``mset``, ``C % tp_size == 0`` and
    :attr:`ModuliSet.supports_partial_decode`; else a warning, a counted
    fallback and None).  ``dp`` is ``()`` when M does not divide it (the
    rows then run whole on every rank) and under ``ctx.rows_local`` (the
    train step: each dp rank's rows are its own already, and gathering
    them would mix ranks that hold different rows).
    """
    ctx = _sh.get_shard_ctx()
    if ctx is None:
        return None
    tp = ctx.resolve("tp")
    tp_size = ctx.axis_size(tp) if tp else 1
    if not tp or tp_size <= 1:
        return None
    dp = ctx.resolve("dp")
    if not dp or ctx.rows_local or M % ctx.axis_size(dp):
        dp = ()
    if ctx.channel_shard:
        if mset is None:
            _fallback("no moduli metadata reached the planner (legacy "
                      "entry point passes no mset)")
            return None
        if mset.num_channels % tp_size:
            _fallback(f"C={mset.num_channels} channels do not divide the "
                      f"tensor axis ({tp_size} devices)")
            return None
        if not mset.supports_partial_decode:
            _fallback(f"moduli set {mset.moduli} exceeds the int32 "
                      "partial-CRT bound (sequential MRC decode required)")
            return None
        return ("chan", ctx.mesh, dp, tp)
    if N % tp_size:
        return None
    return ("col", ctx.mesh, dp, tp)


def weight_plan(t: ResidueTensor, M: int):
    """The plan for ``t`` at M activation rows: :func:`tp_shard_plan`'s,
    its ``"col"`` turned ``"row"`` where ``t``'s planes hold K over the
    tensor axes (a row-parallel weight of the default layout)."""
    shard = tp_shard_plan(M, t.shape[-1], mset=t.mset)
    sh = t.sharding
    if shard is None or shard[0] != "col" or sh is None \
            or sh.ctx.mesh is not shard[1]:
        return shard
    if _sh.spec_axes(sh.planes[t.channel_axis + 1]) == shard[3]:
        return ("row",) + shard[1:]
    return shard


_PLAN_AXIS = {"chan": 0, "row": 1, "col": 2}


def plan_planes(t: ResidueTensor, shard) -> torch.Tensor:
    """This rank's planes block for ``shard``: the columns (N over tp) of
    a ``"col"`` plan, the K rows of a ``"row"`` plan, the channels (C over
    tp) of a ``"chan"`` plan, the whole planes with no plan; gathered and
    cut from the block the tensor holds (FSDP's split over dp comes
    together here)."""
    nd = t.planes.dim()
    want: list = [None] * nd
    if shard is not None:
        kind, mesh, _, tp = shard
        want[t.channel_axis + _PLAN_AXIS[kind]] = tp if len(tp) > 1 \
            else tp[0]
    sh = t.sharding
    if sh is None:
        if shard is None:
            return t.planes
        return _sh.relayout(t.planes, mesh, (None,) * nd, want)
    if shard is not None and sh.ctx.mesh is not mesh:
        return _sh.relayout(t.unsharded().planes, mesh, (None,) * nd, want)
    return _sh.relayout(t.planes, sh.ctx.mesh, sh.planes, want)


def _mapped(a: torch.Tensor, shard, body) -> torch.Tensor:
    """``body`` on this rank's rows of ``a`` (over dp); a ``"col"`` body's
    columns gathered over tp, a ``"row"`` body's partials summed over tp,
    then the rows gathered over dp."""
    kind, mesh, dp, tp = shard
    if dp:
        a = collectives.block_of(a, a.dim() - 2, mesh, dp)
    out = body(a)
    if kind == "col":
        out = collectives.all_gather(out, out.dim() - 1, mesh, tp)
    elif kind == "row":
        out = collectives.all_reduce(out, mesh, tp)
    if dp:
        out = collectives.all_gather(out, out.dim() - 2, mesh, dp)
    return out


def _channel_ids(mesh, tp, C_loc: int) -> list[int]:
    """Global channel ids of this rank's channels: block ``i`` of the C
    axis lies on the rank whose linear index over the tp axes (major to
    minor) is ``i``."""
    base = collectives.axis_index(mesh, tp) * C_loc
    return list(range(base, base + C_loc))


def _row_cut(K: int, segs: list[tuple[int, int]], mesh, tp
             ) -> tuple[int, int, list[tuple[int, int]]]:
    """This rank's K rows ``[k0, k1)`` under a ``"row"`` plan and the
    matmul's segments cut at them, as offsets from ``k0``."""
    k_loc = K // collectives.axis_size(mesh, tp)
    k0 = collectives.axis_index(mesh, tp) * k_loc
    k1 = k0 + k_loc
    return k0, k1, [(max(lo, k0) - k0, min(hi, k1) - k0)
                    for lo, hi in segs if lo < k1 and hi > k0]


def _fold_segments(parts: list[torch.Tensor], mset: ModuliSet, mesh, tp,
                   witness: bool) -> torch.Tensor:
    """One all-reduce of every segment's partials, then a fold a
    segment."""
    buf = collectives.all_reduce(torch.stack(parts, dim=0), mesh, tp)
    total = None
    for s in range(len(parts)):
        part = (mset.corrected_fold(buf[s, 0], buf[s, 1:]) if witness
                else mset.fold_partials(buf[s, 0]))
        total = part if total is None else total + part
    return total


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
            max_abs_a: int, max_abs_b: int, verify: bool = True,
            shard=None) -> torch.Tensor:
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

    ``shard``: a :func:`weight_plan`; ``b_res`` is then this rank's
    block of it (:func:`plan_planes`) and every rank returns the whole
    result (module docstring).
    """
    segs = rns_segments(a.shape[-1], max_abs_a, max_abs_b, mset)
    if shard is None:
        return _rns_local(a, b_res, segs, mset, verify)
    kind, mesh, _, tp = shard
    if kind == "chan":
        return _mapped(a, shard, lambda x: _rns_channel_body(
            x, b_res, segs, mset, verify, mesh, tp))
    if kind == "row":
        k0, k1, segs = _row_cut(a.shape[-1], segs, mesh, tp)
        return _mapped(a, shard, lambda x: _rns_local(
            x[..., k0:k1], b_res, segs, mset, verify))
    return _mapped(a, shard, lambda x: _rns_local(x, b_res, segs, mset,
                                                  verify))


def _rns_local(a: torch.Tensor, b_res: torch.Tensor,
               segs: list[tuple[int, int]], mset: ModuliSet,
               verify: bool) -> torch.Tensor:
    """:func:`rns_run` on the planes this process holds, over ``segs``."""
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
    # The reverse conversion: B9 (the "ref" impl on the CPU) decodes each
    # segment in place into the sum wherever the decode is from_residues;
    # only the witness check stays eager.  The choice follows the set alone,
    # so a step's work counts the same on every device.
    checked = verify and mset.redundant >= 2
    decode = mset.corrected_decode if checked \
        else get_impl("rns_decode", a.device)
    counter = "numerics.decode_kernel" if not checked and a.is_cuda \
        else "numerics.decode_eager"
    # (C, [S,] M, K); a stack is seen as (S, C, M, K), not copied
    with tracing.span("numerics.encode"):
        a_res = mset.to_residues(a.to(torch.int32)).to(_res_dtype(mset))
    if stacked:
        a_res = a_res.movedim(0, 1)
    total = None
    for lo, hi in segs:
        out_res = impl(a_res[..., lo:hi], b_res[..., lo:hi, :], mset.moduli)
        with tracing.span("numerics.decode"):
            if checked:
                part = decode(out_res.movedim(-3, 0))
                total = part if total is None else total + part
            else:
                total = decode(out_res, mset.info, total)
            tracing.count(counter, total.numel())
    return total


def _rns_channel_body(a: torch.Tensor, b_res: torch.Tensor,
                      segs: list[tuple[int, int]], mset: ModuliSet,
                      verify: bool, mesh, tp) -> torch.Tensor:
    """The ``"chan"`` body: ``b_res`` holds this rank's ``(C_loc, K, N)``
    channels (``(S, C_loc, K, N)`` for a stack: B1's stack mode over S x
    C_loc folded channels).  The kernel runs on them with their own moduli,
    each segment becomes a CRT partial (a redundant set's witness channels
    add their canonical residues), and :func:`_fold_segments` all-reduces
    and folds."""
    cid = _channel_ids(mesh, tp, b_res.shape[-3])
    moduli = [mset.moduli[c] for c in cid]
    witness = verify and mset.redundant >= 2
    impl = get_impl("rns_matmul", a.device)
    with tracing.span("numerics.encode"):
        a_res = mset.to_residues(a, channel_ids=cid).to(_res_dtype(mset))
    if a.dim() == 3:
        a_res = a_res.movedim(0, 1)
    parts = []
    for lo, hi in segs:
        cf = impl(a_res[..., lo:hi], b_res[..., lo:hi, :],
                  moduli).movedim(-3, 0)
        with tracing.span("numerics.decode"):
            rows = mset.partial_decode(cf, cid)[None]
            if witness:
                rows = torch.cat([rows, mset.partial_witnesses(cf, cid)])
        parts.append(rows)
    return _fold_segments(parts, mset, mesh, tp, witness)


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
              max_abs_a: int, max_abs_b: int, force_matvec: bool = False,
              shard=None) -> torch.Tensor:
    """(M, K) integer activation x (C, K, N, n) digit planes -> exact (M, N)
    int32.

    The activation's centered residues become SD digits, each K segment's
    digit product decodes exactly (``sdrns_decode``), and the segments sum.
    ``force_matvec`` (the ``sd_matvec`` layout) pins the matvec schedule;
    it takes M in row blocks of :data:`DECODE_M`.  ``shard``: as in
    :func:`rns_run`.
    """
    segs = sdrns_segments(a.shape[-1], max_abs_a, max_abs_b, mset)
    if shard is None:
        return _sdrns_local(a, b_dig, segs, mset, force_matvec)
    kind, mesh, _, tp = shard
    if kind == "chan":
        return _mapped(a, shard, lambda x: _sdrns_channel_body(
            x, b_dig, segs, mset, force_matvec, mesh, tp))
    if kind == "row":
        k0, k1, segs = _row_cut(a.shape[-1], segs, mesh, tp)
        return _mapped(a, shard, lambda x: _sdrns_local(
            x[:, k0:k1], b_dig, segs, mset, force_matvec))
    return _mapped(a, shard, lambda x: _sdrns_local(x, b_dig, segs, mset,
                                                    force_matvec))


def _sdrns_local(a: torch.Tensor, b_dig: torch.Tensor,
                 segs: list[tuple[int, int]], mset: ModuliSet,
                 force_matvec: bool) -> torch.Tensor:
    """:func:`sdrns_run` on the digit planes this process holds, over
    ``segs``."""
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
    with tracing.span("numerics.encode"):
        a_dig = sd.from_int(mset.to_residues(a.to(torch.int32)), n)
    rows = DECODE_M if matvec else M
    total = None
    for lo, hi in segs:
        outs = [impl(a_dig[:, r:r + rows, lo:hi], b_dig[:, lo:hi], ws)
                for r in range(0, M, rows)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        with tracing.span("numerics.decode"):
            part = sdrns.sdrns_decode(out, mset)
            total = part if total is None else total + part
    return total


def _sdrns_channel_body(a: torch.Tensor, b_dig: torch.Tensor,
                        segs: list[tuple[int, int]], mset: ModuliSet,
                        force_matvec: bool, mesh, tp) -> torch.Tensor:
    """The ``"chan"`` body over this rank's ``(C_loc, K, N, n)`` digit
    planes: B6 / B7 with the local channels' wrap signs, each segment's
    digit vectors to residue values (``sd.to_int``; the partial
    canonicalizes, so the representative cannot change the fold), then
    :func:`_fold_segments` (sdrns carries no witness channels)."""
    n = _digit_width(mset)
    M = a.shape[0]
    cid = _channel_ids(mesh, tp, b_dig.shape[0])
    matvec = force_matvec or M <= DECODE_M
    impl = get_impl("sdrns_matvec" if matvec else "sdrns_matmul", a.device)
    ws = [sdrns.WRAP_SIGNS[mset.kinds[c][0]] for c in cid]
    with tracing.span("numerics.encode"):
        a_dig = sd.from_int(mset.to_residues(a, channel_ids=cid), n)
    rows = DECODE_M if matvec else M
    parts = []
    for lo, hi in segs:
        outs = [impl(a_dig[:, r:r + rows, lo:hi], b_dig[:, lo:hi], ws)
                for r in range(0, M, rows)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        with tracing.span("numerics.decode"):
            parts.append(mset.partial_decode(sd.to_int(out), cid)[None])
    return _fold_segments(parts, mset, mesh, tp, witness=False)


def sd_add_run(x: torch.Tensor, y: torch.Tensor, *, kind: str
               ) -> torch.Tensor:
    """Batched carry-free SD addition of (..., n) int8 digit tensors;
    (..., n + 1) out for ``kind="plain"``."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    return get_impl("sd_add", x.device)(x.to(torch.int8), y.to(torch.int8),
                                        kind)
