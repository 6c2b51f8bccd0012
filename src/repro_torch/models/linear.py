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
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import api as nx
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant import residency
from repro_torch.quant.quant import qmax_for_bits, quantize_symmetric

__all__ = ["dense", "init_dense", "stacked_qmatmul"]


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
        t = residency.prepare_weight(w, system=system, bits=bits, mset=mset)
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


def dense(params: dict[str, Any], x: torch.Tensor, *, system: str = "bns",
          bits: int = 4, mset: ModuliSet = P21,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w under ``system``; x: (..., d_in) -> (..., d_out).

    ``params["w"]`` is a resident :class:`ResidueTensor` (prepared) or a
    float ``(d_in, d_out)`` weight (the per-call path under ``rns`` /
    ``sdrns``, differentiable)."""
    w = params["w"]
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
    (*stack, M, N) f32.

    Per-row int4 codes of ``x`` (an all-zero row, an empty expert slot,
    quantizes to zeros), ``nx.einsum`` on the planes, then ``acc * sx *
    w.scale``; a float stack is quantized per output channel (over K) on
    each call.
    """
    x = x.to(torch.float32)
    if isinstance(w, ResidueTensor):
        _check_resident(w, bits, mset, system, where="stacked_qmatmul")
        return _qmatmul_resident(x, w, bits, subscripts)
    if system not in residency.SYSTEM_LAYOUT:
        raise ValueError(f"unknown system {system!r}")
    return _QMatmul.apply(x, w.to(torch.float32), subscripts, system, bits,
                          mset)
