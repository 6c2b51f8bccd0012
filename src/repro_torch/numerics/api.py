"""The typed numerics surface: encode / matmul / add / decode.

    spec = EncodeSpec(layout="rns", mset=P21, qbits=4)   # or layout="sd"
    t = encode(w, spec)            # quantize + forward-convert, paid once
    y = matmul(qx, t)              # exact int32 product of the integers
    z = einsum("ecd,edf->ecf", qb, te)   # the same over a stack (MoE)
    s = add(t, u)                  # carry-free SD addition (sd layouts)
    v = decode(t)                  # reverse conversion (times the scale)
    t, det, cor = scrub(t)         # repair a redundant set's faulty channels

Layouts: ``"rns"`` (centered residue planes, the channel-wise matmul),
``"sd"`` (SD digit planes, the fused signed-digit matmul; decode shapes go
to its matvec schedule) and ``"sd_matvec"`` (the matvec schedule pinned).

The kernel implementation follows the tensors' device (numerics/registry).

Under an installed :class:`~repro_torch.parallel.sharding.ShardCtx`,
:func:`matmul` and :func:`einsum` resolve a plan from the context, the
tensor's moduli set and where its planes sit (``runners.weight_plan``),
take this rank's planes block for it (``runners.plan_planes``) and run the
runner's per-rank body; every rank gets the whole result.  A sharded tensor decodes and scrubs as
the whole tensor does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import runners
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel.sharding import relayout
from repro_torch.quant.quant import qmax_for_bits, quantize_symmetric

__all__ = ["EncodeSpec", "encode", "decode", "scrub", "matmul", "einsum",
           "add"]

ENCODE_LAYOUTS = ("rns", "sd", "sd_matvec")


@dataclasses.dataclass(frozen=True)
class EncodeSpec:
    """Static recipe for a forward conversion.

    layout: ``"rns"`` (residue planes), ``"sd"`` or ``"sd_matvec"`` (SD
      digit planes; they need a special 2^n-1 / 2^n / 2^n+1 set without
      redundant channels).  The packed KV page storage is written by
      ``numerics/kv_pages``.
    qbits: quantization width of float inputs, and the magnitude bound of
      the encoded integers (it drives K-segmentation in :func:`matmul`).
    """

    layout: str = "rns"
    mset: ModuliSet = P21
    qbits: int | None = None

    def __post_init__(self):
        if self.layout not in ENCODE_LAYOUTS:
            raise ValueError(f"encode writes the layouts {ENCODE_LAYOUTS}, "
                             f"got {self.layout!r}")
        if self.layout != "rns" and self.mset.redundant:
            raise ValueError(
                "signed-digit layouts cannot carry redundant channels "
                "(redundant moduli are generic, not special); use "
                "layout='rns' for fault-tolerant residency")

    @property
    def bound(self) -> int | None:
        return None if self.qbits is None else qmax_for_bits(self.qbits)


def encode(w: torch.Tensor, spec: EncodeSpec | None = None) -> ResidueTensor:
    """Forward conversion: (..., K, N) values -> :class:`ResidueTensor`.

    Float ``w`` is quantized symmetrically to ``spec.qbits`` per output
    channel (over K) first, and the scale rides on the tensor.
    """
    spec = spec or EncodeSpec()
    if w.dim() < 2:
        raise ValueError(f"encode needs a (..., K, N) value, got "
                         f"{tuple(w.shape)}")
    scale = None
    if w.is_floating_point():
        if spec.qbits is None:
            raise ValueError("float input needs EncodeSpec.qbits")
        w, scale = quantize_symmetric(w, spec.qbits, axis=-2)
    if spec.layout == "rns":
        planes = runners.encode_rns_planes(w, spec.mset)
    else:
        planes = runners.encode_sd_planes(w, spec.mset)
    return ResidueTensor(planes=planes, scale=scale, mset=spec.mset,
                         layout=spec.layout, qbits=spec.qbits,
                         max_abs=spec.bound)


def decode(t: ResidueTensor, *, check: bool = False) -> torch.Tensor:
    """int32 codes, or f32 ``codes * scale`` when ``t`` carries a scale.

    ``check=True`` on a redundant ``rns`` tensor decodes through
    :meth:`ModuliSet.corrected_decode`: a single corrupted channel is
    rebuilt in line and the value equals the fault-free decode.  Redundant
    ``rns_pack`` pages are checked by ``kv_pages.verify_pages`` instead, so
    ``check=True`` raises on them rather than decode unchecked.
    """
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"decode expects a ResidueTensor, got {type(t)}")
    t = t.unsharded()
    if check and t.mset.redundant and t.layout == "rns":
        cf = t.planes.movedim(t.channel_axis, 0).to(torch.int32)
        codes = t.mset.corrected_decode(cf)
    elif check and t.mset.redundant:
        raise ValueError(f"decode(check=True) supports the 'rns' layout, got "
                         f"{t.layout!r} (redundant rns_pack pages go through "
                         "kv_pages.verify_pages)")
    else:
        codes = t.to_int()
    if t.scale is not None:
        return codes.to(torch.float32) * t.scale
    return codes


def scrub(t: ResidueTensor, *, sync: bool = True):
    """Verify and repair a redundant ``rns`` tensor (``ModuliSet.correct``).

    Returns ``(fixed, detected, corrected)``: a tensor with repaired planes
    and the counts of inconsistent and repaired elements, host ints, or
    with ``sync=False`` 0-d device tensors the caller reads later (the
    engine's overlapped scrub).  Sets without redundancy come back as they
    are with zero counts.  A sharded tensor is checked whole (its blocks
    gathered) and comes back as this rank's block of the repaired planes,
    with the whole tensor's counts.
    """
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"scrub expects a ResidueTensor, got {type(t)}")
    if t.mset.redundant == 0:
        zero = torch.zeros((), dtype=torch.int64, device=t.planes.device)
        return (t, 0, 0) if sync else (t, zero, zero)
    if t.layout != "rns":
        raise ValueError(f"scrub supports the 'rns' layout, got {t.layout!r}"
                         " (redundant rns_pack pages go through "
                         "kv_pages.verify_pages)")
    whole = t.unsharded()
    cf = whole.planes.movedim(t.channel_axis, 0).to(torch.int32)
    fixed, det, cor = t.mset.correct(cf)
    fixed = fixed.movedim(0, t.channel_axis).to(t.planes.dtype)
    if t.sharding is not None:
        sh = t.sharding
        fixed = relayout(fixed, sh.ctx.mesh, (None,) * fixed.dim(),
                         sh.planes).clone(
                             memory_format=torch.contiguous_format)
    t2 = t._with_planes(fixed)
    det, cor = det.sum(), cor.sum()
    return (t2, int(det), int(cor)) if sync else (t2, det, cor)


def matmul(a: torch.Tensor, t: ResidueTensor, *,
           max_abs_a: int | None = None) -> torch.Tensor:
    """Exact integer matmul of an (M, K) activation against encoded planes.

    ``max_abs_a`` bounds |a| (defaults to the tensor's own bound).  Only
    ``a`` is forward-converted per call; the planes are consumed as they
    are: ``rns`` through ``runners.rns_run`` (a redundant set's witness
    planes checked at the decode), the sd layouts through
    ``runners.sdrns_run``.  Returns (M, N) int32.
    """
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"matmul expects a ResidueTensor operand, got "
                        f"{type(t)}; encode the weight first")
    if t.layout not in ENCODE_LAYOUTS:
        raise ValueError(f"matmul needs one of the layouts {ENCODE_LAYOUTS}"
                         f", got {t.layout!r}")
    if t.stack_shape:
        raise ValueError(f"matmul takes a 2-D encoded weight, got stacked "
                         f"value shape {t.shape}")
    if a.dim() != 2:
        raise ValueError(f"matmul takes a 2-D activation, got "
                         f"{tuple(a.shape)}")
    if t.max_abs is None:
        raise ValueError("tensor has no magnitude bound (encode with "
                         "qbits=); the bound drives K-segmentation")
    maa = t.max_abs if max_abs_a is None else max_abs_a
    shard = runners.weight_plan(t, a.shape[0])
    planes = runners.plan_planes(t, shard)
    if t.is_sd:
        return runners.sdrns_run(a, planes, mset=t.mset, max_abs_a=maa,
                                 max_abs_b=t.max_abs,
                                 force_matvec=t.layout == "sd_matvec",
                                 shard=shard)
    return runners.rns_run(a, planes, mset=t.mset, max_abs_a=maa,
                           max_abs_b=t.max_abs, shard=shard)


def _parse_stacked(subscripts: str) -> int:
    """Validate a stacked-matmul einsum spec; return the stack rank.

    Supported: ``<stack>mk,<stack>kn-><stack>mn`` with the same stack
    letters on all three terms, e.g. ``"ecd,edf->ecf"`` (the MoE expert
    stack) or ``"mk,kn->mn"`` (a plain matmul).
    """
    try:
        lhs, out = subscripts.replace(" ", "").split("->")
        a_sub, b_sub = lhs.split(",")
    except ValueError as e:
        raise ValueError(f"malformed einsum spec {subscripts!r}") from e
    unsupported = ValueError(f"unsupported einsum spec {subscripts!r}: need "
                             "'<stack>mk,<stack>kn-><stack>mn'")
    if len(a_sub) < 2 or len(a_sub) != len(b_sub) or len(a_sub) != len(out):
        raise unsupported
    stack = a_sub[:-2]
    m, k = a_sub[-2], a_sub[-1]
    letters = stack + m + k + b_sub[-1]
    if (b_sub[:-2] != stack or out[:-2] != stack
            or b_sub[-2] != k or out[-2] != m or out[-1] != b_sub[-1]
            or len(letters) != len(set(letters))):
        raise unsupported
    return len(stack)


def einsum(subscripts: str, a: torch.Tensor, t: ResidueTensor, *,
           max_abs_a: int | None = None) -> torch.Tensor:
    """Stacked exact integer matmul: the residue-resident MoE expert
    einsums.

    ``"<stack>mk,<stack>kn-><stack>mn"`` specs, e.g. ``einsum("ecd,edf->ecf",
    tokens, w_experts)`` for an (E, C, d) integer token buffer against
    (E, d, f) expert-stacked encoded weights.  Every slice equals
    :func:`matmul` of its own bit for bit.  ``rns`` planes run as one stack
    through ``runners.rns_run`` (one kernel launch a K segment for the
    whole stack, where the reference scans its runner over the slices; on
    the channel plan B1's stack mode runs S x C_loc folded channels);
    the sd layouts run slice by slice through ``runners.sdrns_run``.
    Returns ``(*stack, M, N)`` int32.
    """
    if not isinstance(t, ResidueTensor):
        raise TypeError(f"einsum expects a ResidueTensor operand, got "
                        f"{type(t)}")
    stack_nd = _parse_stacked(subscripts)
    if a.dim() != stack_nd + 2:
        raise ValueError(f"activation rank {a.dim()} does not match spec "
                         f"{subscripts!r} (want {stack_nd + 2})")
    if len(t.stack_shape) != stack_nd:
        raise ValueError(f"encoded operand stack {t.stack_shape} does not "
                         f"match spec {subscripts!r} (want rank "
                         f"{stack_nd})")
    if stack_nd == 0:
        return matmul(a, t, max_abs_a=max_abs_a)
    stack_shape = tuple(a.shape[:stack_nd])
    if tuple(t.stack_shape) != stack_shape:
        raise ValueError(f"stack mismatch: activation {stack_shape} vs "
                         f"encoded {t.stack_shape}")
    if a.shape[-1] != t.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} vs "
                         f"encoded value {t.shape}")
    if t.layout not in ENCODE_LAYOUTS:
        raise ValueError(f"einsum needs one of the layouts {ENCODE_LAYOUTS}"
                         f", got {t.layout!r}")
    if t.max_abs is None:
        raise ValueError("tensor has no magnitude bound (encode with "
                         "qbits=); the bound drives K-segmentation")
    maa = t.max_abs if max_abs_a is None else max_abs_a
    shard = runners.weight_plan(t, a.shape[-2])
    planes = runners.plan_planes(t, shard)
    S = 1
    for n in stack_shape:
        S *= n
    a_r = a.reshape(S, *a.shape[stack_nd:])
    p_r = planes.reshape(S, *planes.shape[stack_nd:])
    if t.is_sd:
        out = torch.stack([runners.sdrns_run(
            a_r[i], p_r[i], mset=t.mset, max_abs_a=maa, max_abs_b=t.max_abs,
            force_matvec=t.layout == "sd_matvec", shard=shard)
            for i in range(S)])
    else:
        out = runners.rns_run(a_r, p_r, mset=t.mset, max_abs_a=maa,
                              max_abs_b=t.max_abs, shard=shard)
    return out.reshape(*stack_shape, *out.shape[1:])


def add(x, y, *, kind: str | None = None):
    """Carry-free SD addition of typed tensors or raw digit arrays.

    * Two :class:`ResidueTensor` operands of one moduli set and layout
      family: per channel, the modular carry-free adder (kernel B8) for the
      sd layouts, centered plane addition for ``rns``.  Returns a
      ResidueTensor.
    * Raw ``(..., n)`` int8 digit tensors with ``kind=`` (``"plain"`` |
      ``"pow2m1"`` | ``"pow2"`` | ``"pow2p1"``): the batched kernel
      directly, ``(..., n + 1)`` out for ``"plain"``.
    """
    if isinstance(x, ResidueTensor) or isinstance(y, ResidueTensor):
        if not (isinstance(x, ResidueTensor)
                and isinstance(y, ResidueTensor)):
            raise TypeError("cannot add a ResidueTensor to a raw array")
        x._check_ring_op(y)
        if kind is not None:
            raise ValueError("kind= is only for raw digit arrays; typed "
                             "tensors carry their own channel kinds")
        if not x.is_sd:
            return x + y
        return x._with_planes(x._per_channel(
            lambda k, a, b: runners.sd_add_run(a, b, kind=k),
            x.planes, y.planes))
    if kind is None:
        raise ValueError("raw digit arrays need kind= "
                         "('plain' | 'pow2m1' | 'pow2' | 'pow2p1')")
    return runners.sd_add_run(x, y, kind=kind)
