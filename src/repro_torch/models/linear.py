"""Dense layer under a switchable number system (port of models/linear.py).

* ``system="bns"``: a plain ``torch.matmul`` in the compute dtype (the
  reference leaves this product to XLA).
* ``system="rns"``: the weight is a residue-resident
  :class:`~repro_torch.numerics.tensor.ResidueTensor` (``quant/residency``);
  only the activation is quantized (int4, per token) and forward-converted
  per call, the residue matmul kernel consumes the resident planes (P21, or
  a redundant set whose witness channels the decode checks), and the exact
  int32 product is dequantized (:func:`_qmatmul_resident`).
* ``system="sdrns"``: the same, over resident SD digit planes (layout
  ``"sd"``), through the fused signed-digit matmul kernels; the int32
  product equals ``rns``'s bit for bit.

A float weight under ``rns`` / ``sdrns`` takes the per-call path (the
reference's ``_qmatmul`` / ``_qeinsum``): the weight is quantized per
output channel and forward-converted on every call, then the product runs
as on the resident path, so its output equals the prepared weight's bit for
bit.  Its backward is straight-through in float32: ``gx = g w^T``, ``gw =
x^T g``, the standard quantization-aware-training treatment (the integer
forward has no gradient of its own).  Prepared weights are inference-only.

:func:`stacked_qmatmul` is the expert-stacked sibling ``models/moe.py``
runs its three einsums through.

In the sharded train step a weight is a
:class:`~repro_torch.parallel.sharding.ShardedParam`, this rank's block.
Its FSDP split over ``dp`` is gathered first (backward: reduce-scatter);
then the plan its ``tp`` spec implies runs, on the activation that every
rank of ``tp`` holds whole:

* column (N over ``tp``): the product of the rank's columns, each with its
  own per-output-channel scale, all-gathered (backward: the local block;
  the input's gradient, partial over the columns, all-reduced);
* row (K over ``tp``): the per-output-channel amax all-reduced with
  ``max``, so each rank's int4 codes equal the whole weight's; the
  activation quantized per token over the whole K and cut to the rank's
  rows; the exact int32 partials all-reduced, or reduce-scattered onto
  sequence shards inside :func:`seq_scatter` (Megatron-SP), then
  dequantized.  So both plans equal the one-process product bit for bit.
  Backward: the straight-through gradients of the rank's rows, the
  input's all-gathered over K;
* no tp split: the product on every rank.

Under ``bns`` the same plans run on float products (the row plan's
partials summed in f32).  The local products run with no shard context:
the plan is this module's.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any

import torch

from repro_torch import tracing
from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import api as nx
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import ShardedParam
from repro_torch.quant import residency
from repro_torch.quant.quant import (qmax_for_bits, quantize_symmetric,
                                     true_divide)

__all__ = ["dense", "init_dense", "stacked_qmatmul", "seq_scatter"]

# inside seq_scatter(): a row-parallel (B, S, N) output goes to sequence
# shards over tp
_SEQ_SCATTER: ContextVar[bool] = ContextVar("repro_torch_seq_scatter",
                                            default=False)


@contextlib.contextmanager
def seq_scatter():
    """Row-plan outputs of 3-D ``(B, S, N)`` products reduce-scatter onto
    sequence shards over tp instead of all-reducing (Megatron-SP)."""
    token = _SEQ_SCATTER.set(True)
    try:
        yield
    finally:
        _SEQ_SCATTER.reset(token)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               device="cuda") -> dict[str, torch.Tensor]:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return {"w": torch.randn(d_in, d_out, generator=gen, device=device)
            * scale}


def _check_resident(w: ResidueTensor, bits: int, mset: ModuliSet,
                    system: str, where: str = "dense") -> None:
    if residency.prepared_kind(w) != system:
        raise ValueError(f"params are residue-resident (layout "
                         f"{w.layout!r}) but {where}() was called with "
                         f"system {system!r}")
    if w.qbits is not None and w.qbits != bits:
        raise ValueError(f"residue-resident params were prepared with "
                         f"bits={w.qbits}, {where}() called with "
                         f"bits={bits}")
    if w.mset.moduli != mset.moduli:
        raise ValueError(f"planes prepared under moduli {w.mset.moduli}, "
                         f"{where}() called with {mset.moduli}")
    if w.scale is None:
        raise ValueError("residue-resident weight carries no scale")


def _qmatmul_resident(x: torch.Tensor, w: ResidueTensor, bits: int,
                      subscripts: str | None = None) -> torch.Tensor:
    """x: (M, K) f32, w: prepared (K, N) -> (M, N) f32; with
    ``subscripts`` the stacked einsum (*stack, M, K) x (*stack, K, N).
    Under a shard context the product comes back whole on every rank, and
    so does the scale of a sharded weight."""
    qmax = qmax_for_bits(bits)
    qx, sx = quantize_symmetric(x, bits, axis=-1)       # per-token scales
    acc = (nx.matmul(qx, w, max_abs_a=qmax) if subscripts is None
           else nx.einsum(subscripts, qx, w, max_abs_a=qmax))
    with tracing.span("numerics.decode"):
        return acc.to(torch.float32) * sx * w.whole_scale()


def _split_subscripts(subscripts: str) -> tuple[str, str, str]:
    lhs, out = subscripts.replace(" ", "").split("->")
    a_sub, b_sub = lhs.split(",")
    return a_sub, b_sub, out


class _QMatmul(torch.autograd.Function):
    """Per-call quantized product of a float x and a float weight w:
    ``subscripts`` None for x (M, K) @ w (K, N), else a stacked einsum
    ``"<stack>mk,<stack>kn-><stack>mn"``.  The weight is made resident for
    this call alone (per-output-channel int4 codes over K, then planes or
    digits), so the forward is the resident path's; the backward is
    straight-through in f32."""

    @staticmethod
    def forward(ctx, x, w, subscripts, system, bits, mset):
        ctx.save_for_backward(x, w)
        ctx.subscripts = subscripts
        with tracing.span("numerics.weight_encode"):
            t = residency.prepare_weight(w, system=system, bits=bits,
                                         mset=mset)
        return _qmatmul_resident(x, t, bits, subscripts)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        x32, w32 = x.to(torch.float32), w.to(torch.float32)
        if ctx.subscripts is None:
            gx, gw = torch.matmul(g, w32.T), torch.matmul(x32.T, g)
        else:
            a_sub, b_sub, out_sub = _split_subscripts(ctx.subscripts)
            gx = torch.einsum(f"{out_sub},{b_sub}->{a_sub}", g, w32)
            gw = torch.einsum(f"{a_sub},{out_sub}->{b_sub}", x32, g)
        return gx.to(x.dtype), gw.to(w.dtype), None, None, None, None


def _local_codes(w: torch.Tensor, bits: int, mesh, tp) -> tuple:
    """Per-output-channel int4 codes (over K, axis -2) of this rank's K rows
    of a weight, on the whole weight's scale: the amax all-reduced with
    ``max`` over ``tp``."""
    qmax = qmax_for_bits(bits)
    amax = coll.all_reduce(w.abs().amax(dim=-2, keepdim=True), mesh, tp,
                           op="max")
    scale = true_divide(torch.clamp(amax, min=1e-8), qmax)
    q = torch.round_(w / scale).clamp_(-qmax, qmax).to(torch.int32)
    return q, scale.to(torch.float32)


class _QMatmulRow(torch.autograd.Function):
    """The row plan of :class:`_QMatmul`: x whole ``(M, K)`` (or ``(*stack,
    M, K)``) on every rank of ``tp``, w this rank's K rows.  With ``seq``
    ``(B, S)`` the int32 sum goes to this rank's sequence shard: ``(B,
    S / tp, N)`` out."""

    @staticmethod
    def forward(ctx, x, w, subscripts, system, bits, mset, mesh, tp, seq):
        ctx.save_for_backward(x, w)
        ctx.args = (subscripts, mesh, tp, seq)
        qmax = qmax_for_bits(bits)
        qx, sx = quantize_symmetric(x, bits, axis=-1)
        qxk = coll.block_of(qx, x.dim() - 1, mesh, tp).contiguous()
        qw, sw = _local_codes(w, bits, mesh, tp)
        spec = nx.EncodeSpec(layout=residency.SYSTEM_LAYOUT[system],
                             mset=mset, qbits=bits)
        with sharding.shard_ctx(None):
            t = nx.encode(qw, spec)
            acc = (nx.matmul(qxk, t, max_abs_a=qmax) if subscripts is None
                   else nx.einsum(subscripts, qxk, t, max_abs_a=qmax))
        if seq is None:
            acc = coll.all_reduce(acc, mesh, tp)
        else:
            acc = coll.reduce_scatter(acc.view(*seq, -1), mesh, tp, 1)
            sx = coll.block_of(sx.view(*seq, 1), 1, mesh, tp)
        return acc.to(torch.float32) * sx * sw

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        subscripts, mesh, tp, seq = ctx.args
        g = g.to(torch.float32)
        if seq is not None:
            g = coll.all_gather(g, 1, mesh, tp).reshape(-1, g.shape[-1])
        xk = coll.block_of(x, x.dim() - 1, mesh, tp).to(torch.float32)
        w32 = w.to(torch.float32)
        if subscripts is None:
            gxk, gw = torch.matmul(g, w32.T), torch.matmul(xk.T, g)
        else:
            a_sub, b_sub, out_sub = _split_subscripts(subscripts)
            gxk = torch.einsum(f"{out_sub},{b_sub}->{a_sub}", g, w32)
            gw = torch.einsum(f"{a_sub},{out_sub}->{b_sub}", xk, g)
        gx = coll.all_gather(gxk, x.dim() - 1, mesh, tp)
        return (gx.to(x.dtype), gw.to(w.dtype), None, None, None, None, None,
                None, None)


def _sharded(x: torch.Tensor, w: ShardedParam, subscripts: str | None,
             system: str, bits: int, mset: ModuliSet, cd) -> torch.Tensor:
    """The plan of a ShardedParam weight (module docstring): x ``(..., K)``
    for a plain product, ``(*stack, M, K)`` for ``subscripts``; the output
    in ``cd`` (f32 for a stacked product)."""
    ctx = w.ctx
    mesh, tp = ctx.mesh, ctx.tp
    xdt = x.dtype           # a float einsum's operands take the input's
    wt = w.gather_dp()
    d = w.tp_dim()
    nd = wt.dim()
    if d is not None and d < nd - 2:
        raise ValueError(f"a weight split over tp on its stack dim {d} "
                         f"(expert parallelism) runs in models/moe.py")
    seq = None
    if (d == nd - 2 and subscripts is None and _SEQ_SCATTER.get()
            and x.dim() == 3):
        seq = tuple(x.shape[:2])
        if seq[1] % coll.axis_size(mesh, tp):
            raise ValueError(f"seq_shard: S {seq[1]} does not divide the "
                             f"tensor axes ({coll.axis_size(mesh, tp)})")
    if d == nd - 1:     # column: the input's partial gradients summed in f32
        x = coll.diff_identity(x.to(torch.float32), mesh, tp)
    if d != nd - 2:                                     # column, or whole
        with sharding.shard_ctx(None):
            if subscripts is None:
                y = dense({"w": wt}, x, system=system, bits=bits, mset=mset,
                          compute_dtype=cd)
            elif system == "bns":
                y = torch.einsum(subscripts, x.to(xdt).float(),
                                 wt.to(xdt).float())
            else:
                y = stacked_qmatmul(subscripts, x, wt, system=system,
                                    bits=bits, mset=mset)
        return y if d is None else coll.diff_all_gather(y, -1, mesh, tp)
    if system == "bns":                                 # row, float
        xk = coll.diff_slice(x, -1, mesh, tp)
        part = (torch.matmul(xk.to(cd).float(), wt.to(cd).float())
                if subscripts is None else
                torch.einsum(subscripts, xk.float(), wt.to(xdt).float()))
        y = (coll.diff_all_reduce(part, mesh, tp) if seq is None else
             coll.diff_reduce_scatter(part, 1, mesh, tp))
        return y.to(cd) if subscripts is None else y
    if system not in residency.SYSTEM_LAYOUT:
        raise ValueError(f"unknown system {system!r}")
    lead = x.shape[:-1]
    x2 = (x.reshape(-1, x.shape[-1]) if subscripts is None else x).to(
        torch.float32)
    y = _QMatmulRow.apply(x2, wt.to(torch.float32), subscripts, system, bits,
                          mset, mesh, tp, seq)
    if subscripts is not None:
        return y
    if seq is None:
        y = y.reshape(*lead, y.shape[-1])
    return y.to(cd)


def dense(params: dict[str, Any], x: torch.Tensor, *, system: str = "bns",
          bits: int = 4, mset: ModuliSet = P21,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w under ``system``; x: (..., d_in) -> (..., d_out).

    ``params["w"]`` is a resident :class:`ResidueTensor` (prepared) or a
    float ``(d_in, d_out)`` weight (the per-call path under ``rns`` /
    ``sdrns``, differentiable)."""
    w = params["w"]
    if isinstance(w, ShardedParam):
        return _sharded(x, w, None, system, bits, mset, compute_dtype)
    if system == "bns" and not isinstance(w, ResidueTensor):
        return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if isinstance(w, ResidueTensor):
        _check_resident(w, bits, mset, system)
        y2 = _qmatmul_resident(x2, w, bits)
    elif system in residency.SYSTEM_LAYOUT:
        y2 = _QMatmul.apply(x2, w.to(torch.float32), None, system, bits,
                            mset)
    else:
        raise ValueError(f"unknown system {system!r}")
    return y2.reshape(*lead, y2.shape[-1]).to(compute_dtype)


def stacked_qmatmul(subscripts: str, x: torch.Tensor, w, *, system: str,
                    bits: int = 4, mset: ModuliSet = P21) -> torch.Tensor:
    """Quantized stacked einsum: x (*stack, M, K), w (*stack, K, N) resident
    planes or a float stack (the per-call path, differentiable) ->
    (*stack, M, N) f32.  A :class:`ShardedParam` stack runs its plan
    (module docstring), under ``bns`` too (a float einsum, the operand's
    dtype for both sides).

    Per-row int4 codes of ``x`` (an all-zero row, an empty expert slot,
    quantizes to zeros), ``nx.einsum`` on the planes, then ``acc * sx *
    w.scale``; a float stack is quantized per output channel (over K) on
    each call.
    """
    if isinstance(w, ShardedParam):
        return _sharded(x, w, subscripts, system, bits, mset, torch.float32)
    x = x.to(torch.float32)
    if isinstance(w, ResidueTensor):
        _check_resident(w, bits, mset, system, where="stacked_qmatmul")
        return _qmatmul_resident(x, w, bits, subscripts)
    if system not in residency.SYSTEM_LAYOUT:
        raise ValueError(f"unknown system {system!r}")
    return _QMatmul.apply(x, w.to(torch.float32), subscripts, system, bits,
                          mset)
