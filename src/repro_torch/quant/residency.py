"""Residue-resident weight preparation: quantize once, convert once.

:func:`prepare_weight` turns a float ``(..., K, N)`` weight into an int4
:class:`~repro_torch.numerics.tensor.ResidueTensor` of residue planes (P21
by default, witness planes included for a redundant set) with a
per-output-channel scale, bit-identical to the reference's
``repro/quant/residency.py::prepare_weight``.  The float weight is not
kept: prepared weights are inference-only.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import api as nx
from repro_torch.numerics.tensor import ResidueTensor

__all__ = ["prepare_weight", "prepare_dense", "map_resident"]


def prepare_weight(w: torch.Tensor, *, system: str, bits: int = 4,
                   mset: ModuliSet = P21) -> ResidueTensor:
    """Float weight (..., K, N) -> residue-resident :class:`ResidueTensor`.

    Symmetric quantization per output channel (reduction over K, axis -2);
    leading stack axes are preserved.
    """
    if system != "rns":
        raise ValueError(f"prepare_weight: system must be 'rns', got "
                         f"{system!r}")
    if isinstance(w, ResidueTensor):
        if w.qbits != bits or w.mset.moduli != mset.moduli:
            raise ValueError(
                f"weight already residue-resident as (bits={w.qbits}, "
                f"moduli={w.mset.moduli}); cannot re-prepare for "
                f"(bits={bits}, moduli={mset.moduli})")
        return w
    if w.dim() < 2:
        raise ValueError(f"dense weight must be at least 2-D, got "
                         f"{tuple(w.shape)}")
    spec = nx.EncodeSpec(layout="rns", mset=mset, qbits=bits)
    return nx.encode(w.to(torch.float32), spec)


def prepare_dense(params: dict[str, Any], *, system: str, bits: int = 4,
                  mset: ModuliSet = P21) -> dict[str, Any]:
    """``{"w": float}`` -> ``{"w": ResidueTensor}``."""
    return {"w": prepare_weight(params["w"], system=system, bits=bits,
                                mset=mset)}


def map_resident(params: Any, fn: Callable[[ResidueTensor], Any]) -> Any:
    """A copy of the parameter tree with ``fn`` applied to every resident
    weight, visited in sorted-key order (the reference's tree order)."""
    if isinstance(params, ResidueTensor):
        return fn(params)
    if isinstance(params, dict):
        return {k: map_resident(params[k], fn) for k in sorted(params)}
    if isinstance(params, list):
        return [map_resident(v, fn) for v in params]
    return params
