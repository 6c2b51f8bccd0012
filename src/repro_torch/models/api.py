"""Model API: ``build_model(cfg, system=..., device=...)``.

The returned :class:`Model` bundles the dense-family functions:

* ``init(seed)`` -- random parameters on the model's device.  Under
  ``system="rns"`` each layer is made residue-resident right after it is
  made, so only one layer's float weights exist at a time (at qwen3-8b's
  full width that keeps the peak near the resident size, ~26 GB, instead of
  ~58 GB for all float weights followed by their planes);
* ``prepare_params(params)`` -- the quantize-once / convert-once pass over a
  float tree (identity for ``bns``; idempotent on prepared trees);
* ``prefill(params, tokens, s_max=None, logits_at=None)``;
* ``decode_paged(params, token, kv, block_tab, pos, page_size=...,
  with_syndrome=False)``; with the syndrome it also returns the
  ``(B, L)`` count of KV elements whose witnesses disagree (rns8r pages).

Entry points run on the card: ``device`` defaults to ``"cuda"`` and a
missing card raises; callers ask for the CPU with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.moduli import ModuliSet
from repro_torch.models import transformer as tf_mod
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant import residency

__all__ = ["Model", "build_model", "resolve_device", "resident_bytes"]


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises when a CUDA device is asked for and no
    card is present (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    prepare_params: Callable[[Any], Any]
    prefill: Callable[..., Any]
    decode_paged: Callable[..., Any]


def build_model(cfg: ArchConfig, *, system: str = "bns",
                device: torch.device | str = "cuda",
                rns_bits: int = 4,
                rns_mset: ModuliSet | None = None) -> Model:
    """``rns_mset`` (``system="rns"`` only) picks the resident planes' moduli
    set, P21 by default; a redundant set such as ``P21R2`` carries witness
    planes that every residue matmul checks and corrects at its decode."""
    if system not in ("bns", "rns"):
        raise ValueError(f"system must be 'bns' or 'rns', got {system!r}")
    if rns_mset is not None and system != "rns":
        raise ValueError(f"rns_mset= is only meaningful for system='rns', "
                         f"got system={system!r}")
    dev = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)
    dense_kw: dict[str, Any] = {"system": system, "compute_dtype": cd}
    prep_kw: dict[str, Any] = {"system": system, "bits": rns_bits}
    if system == "rns":
        dense_kw["bits"] = rns_bits
        if rns_mset is not None:
            dense_kw["mset"] = prep_kw["mset"] = rns_mset

    def prepare_tree(node, name=None):
        if isinstance(node, list):
            return [prepare_tree(v) for v in node]
        if not isinstance(node, dict):
            return node
        if set(node) == {"w"}:
            return residency.prepare_dense(node, **prep_kw)
        out = {k: prepare_tree(v, k) for k, v in node.items()}
        if name == "embed" and "logits_w" not in out:
            # tied-embedding logits matmul; the f32 table stays for the
            # embedding gather
            out["logits_w"] = residency.prepare_weight(
                out["table"].to(torch.float32).T, **prep_kw)
        return out

    def prepare_params(params):
        """Every dense weight and the tied logits weight (``table.T``,
        stored as ``embed.logits_w``) become residue-resident."""
        if system == "bns":
            return params
        return {k: prepare_tree(v, k) for k, v in params.items()}

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            params = tf_mod.init_lm(
                gen, cfg, device=dev,
                prepare_layer=prepare_tree if system == "rns" else None)
            return prepare_params(params)

    @torch.no_grad()
    def prefill(params, tokens, s_max=None, logits_at=None,
                cache_dtype=torch.bfloat16):
        tokens = torch.as_tensor(tokens, device=dev).long()
        return tf_mod.lm_prefill(params, cfg, tokens, s_max=s_max,
                                 dense_kw=dense_kw, cache_dtype=cache_dtype,
                                 logits_at=logits_at)

    @torch.no_grad()
    def decode_paged(params, token, kv, block_tab, pos, *, page_size,
                     cache_dtype=torch.bfloat16, with_syndrome=False):
        token = torch.as_tensor(token, device=dev).long()
        return tf_mod.lm_decode_paged(
            params, cfg, token, kv, block_tab, pos, page_size=page_size,
            dense_kw=dense_kw, cache_dtype=cache_dtype,
            with_syndrome=with_syndrome)

    return Model(cfg=cfg, device=dev, init=init,
                 prepare_params=prepare_params, prefill=prefill,
                 decode_paged=decode_paged)


def resident_bytes(params: Any) -> int:
    """Bytes of the residue-resident weights (planes and scales)."""
    if isinstance(params, ResidueTensor):
        return params.nbytes()
    if isinstance(params, dict):
        return sum(resident_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(resident_bytes(v) for v in params)
    return 0
