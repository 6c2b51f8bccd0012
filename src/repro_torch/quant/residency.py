"""Residue-resident weight preparation: quantize once, convert once.

:func:`prepare_weight` turns a float ``(..., K, N)`` weight into an int4
:class:`~repro_torch.numerics.tensor.ResidueTensor` with a
per-output-channel scale: residue planes under ``system="rns"`` (P21 by
default, witness planes included for a redundant set), SD digit planes
(layout ``"sd"``) under ``system="sdrns"``; bit-identical to the
reference's ``repro/quant/residency.py::prepare_weight``.  The float
weight is not kept: prepared weights are inference-only.  Under an
installed :class:`~repro_torch.parallel.sharding.ShardCtx` the prepared
tensor keeps this rank's block (``sharding.shard_residue_tensor``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.moduli import P21, ModuliSet
from repro_torch.numerics import api as nx
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel import sharding

__all__ = ["SYSTEM_LAYOUT", "EXPERT_STACKS", "makes_resident",
           "prepared_kind", "prepare_weight", "prepare_dense",
           "map_resident", "dequantize_weight"]

# model-level number system -> ResidueTensor layout tag (and back)
SYSTEM_LAYOUT = {"rns": "rns", "sdrns": "sd"}
_LAYOUT_SYSTEM = {"rns": "rns", "sd": "sdrns", "sd_matvec": "sdrns"}


# the moe layer's bare (E, K, N) expert stacks
EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def makes_resident(name: str | None, node: Any) -> bool:
    """Whether the node under key ``name`` is a weight that a model's
    ``prepare_params`` makes residue-resident: a dense ``{"w": weight}``
    dict, but not the moe router's (routing stays float), or a bare moe
    expert stack."""
    if isinstance(node, dict):
        return set(node) == {"w"} and name != "router"
    return name in EXPERT_STACKS and isinstance(node, torch.Tensor)


def prepared_kind(w: ResidueTensor) -> str | None:
    """The system a resident weight was prepared for (``None`` for a
    storage-only layout)."""
    return _LAYOUT_SYSTEM.get(w.layout)


def prepare_weight(w: torch.Tensor, *, system: str, bits: int = 4,
                   mset: ModuliSet = P21,
                   roles: Any | None = None) -> ResidueTensor:
    """Float weight (..., K, N) -> residue-resident :class:`ResidueTensor`.

    Symmetric quantization per output channel (reduction over K, axis -2);
    leading stack axes are preserved.  Under a shard context the result is
    this rank's block on the specs of ``roles`` (roles of the ``(*stack, K,
    N)`` value; None: the generic dense rule, FSDP on K and TP on N);
    ``roles=False`` keeps it whole (``Model.prepare_params`` places each
    weight by its name rule instead).
    """
    if system not in SYSTEM_LAYOUT:
        raise ValueError(f"prepare_weight: system must be 'rns' or "
                         f"'sdrns', got {system!r}")
    if isinstance(w, ResidueTensor):
        have = prepared_kind(w)
        if have != system or w.qbits != bits or \
                w.mset.moduli != mset.moduli:
            raise ValueError(
                f"weight already residue-resident as (system={have!r}, "
                f"bits={w.qbits}, moduli={w.mset.moduli}); cannot "
                f"re-prepare for (system={system!r}, bits={bits}, "
                f"moduli={mset.moduli}): the float weight was dropped")
        return w
    if w.dim() < 2:
        raise ValueError(f"dense weight must be at least 2-D, got "
                         f"{tuple(w.shape)}")
    spec = nx.EncodeSpec(layout=SYSTEM_LAYOUT[system], mset=mset,
                         qbits=bits)
    t = nx.encode(w.to(torch.float32), spec)
    ctx = sharding.get_shard_ctx()
    if ctx is not None and roles is not False:
        if roles is None:
            roles = [None] * (w.dim() - 2) + ["dp", "tp"]
        t = sharding.shard_residue_tensor(t, roles, ctx)
    return t


def prepare_dense(params: dict[str, Any], *, system: str, bits: int = 4,
                  mset: ModuliSet = P21,
                  roles: Any | None = None) -> dict[str, Any]:
    """``{"w": float}`` -> ``{"w": ResidueTensor}``."""
    return {"w": prepare_weight(params["w"], system=system, bits=bits,
                                mset=mset, roles=roles)}


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


def dequantize_weight(params: dict[str, Any] | ResidueTensor
                      ) -> torch.Tensor:
    """The float weight a prepared node encodes: the exact reverse
    conversion of its planes times the scale (``{"w": ...}`` or the bare
    tensor)."""
    w = params["w"] if isinstance(params, dict) else params
    if not isinstance(w, ResidueTensor):
        raise TypeError(f"expected a prepared node, got {type(w)}")
    return nx.decode(w)
