"""Dense layer under a switchable number system (port of models/linear.py).

* ``system="bns"``: a plain ``torch.matmul`` in the compute dtype (the
  reference leaves this product to XLA).
* ``system="rns"``: the weight is a residue-resident
  :class:`~repro_torch.numerics.tensor.ResidueTensor` (``quant/residency``);
  only the activation is quantized (int4, per token) and forward-converted
  per call, the residue matmul kernel consumes the resident planes (P21, or
  a redundant set whose witness channels the decode checks), and the exact
  int32 product is dequantized (:func:`_qmatmul_resident`).

Prepared weights are inference-only; the per-call quantizing path for float
weights under ``rns`` waits for the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import api as nx
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.quant import qmax_for_bits, quantize_symmetric

__all__ = ["dense", "init_dense"]


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               device="cuda") -> dict[str, torch.Tensor]:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return {"w": torch.randn(d_in, d_out, generator=gen, device=device)
            * scale}


def _check_resident(w: ResidueTensor, bits: int, mset: ModuliSet,
                    system: str) -> None:
    if system != "rns" or w.layout != "rns":
        raise ValueError(f"params are residue-resident (layout "
                         f"{w.layout!r}) but dense() was called with "
                         f"system {system!r}")
    if w.qbits is not None and w.qbits != bits:
        raise ValueError(f"residue-resident params were prepared with "
                         f"bits={w.qbits}, dense() called with bits={bits}")
    if w.mset.moduli != mset.moduli:
        raise ValueError(f"planes prepared under moduli {w.mset.moduli}, "
                         f"dense() called with {mset.moduli}")
    if w.scale is None:
        raise ValueError("residue-resident weight carries no scale")


def _qmatmul_resident(x: torch.Tensor, w: ResidueTensor,
                      bits: int) -> torch.Tensor:
    """x: (M, K) f32, w: prepared (K, N) -> (M, N) f32."""
    qmax = qmax_for_bits(bits)
    qx, sx = quantize_symmetric(x, bits, axis=-1)       # per-token scales
    acc = nx.matmul(qx, w, max_abs_a=qmax)
    return acc.to(torch.float32) * sx * w.scale


def dense(params: dict[str, Any], x: torch.Tensor, *, system: str = "bns",
          bits: int = 4, mset: ModuliSet = P21,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w under ``system``; x: (..., d_in) -> (..., d_out)."""
    w = params["w"]
    if isinstance(w, ResidueTensor):
        _check_resident(w, bits, mset, system)
        lead = x.shape[:-1]
        y2 = _qmatmul_resident(x.reshape(-1, x.shape[-1]).to(torch.float32),
                               w, bits)
        return y2.reshape(*lead, y2.shape[-1]).to(compute_dtype)
    if system == "bns":
        return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if system == "rns":
        raise ValueError("system='rns' needs residue-resident weights: run "
                         "the parameters through Model.prepare_params first")
    raise ValueError(f"unknown system {system!r}")
