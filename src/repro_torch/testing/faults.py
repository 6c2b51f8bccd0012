"""Fault injection for the redundant-residue serving path.

Port of ``repro/testing/faults.py``.  :func:`inject_faults` patches a
:class:`~repro_torch.serving.engine.ServingEngine` so that its next decode
segment is split in two at ``after_steps`` tokens, with bit flips applied
to residue state between the halves: mid-decode, inside one ``generate()``
call, after real KV rows have been written.

Faults are described by :class:`FaultSpec`:

* ``kind="weight"`` -- flip ``bit`` in residue ``channel`` of the
  ``leaf``-th residue-resident weight tensor (sorted-key tree order) at
  flat element ``index`` of that channel's plane.  Leaf 0 is the tied
  logits weight in both packages; the port's layers are separate tensors
  where the reference stacks them, so higher leaves number differently.
* ``kind="kv"`` -- flip ``bit`` in lane ``channel`` of the paged KV pool
  (``which`` picks K or V), addressed by ``at`` (a multi-index into the
  lane-removed planes ``(L, P, ps, Kv, hdp)``) or by flat ``index``.
* ``kind="kv_sticky"`` -- as ``"kv"``, but the bit flips again after every
  targeted repair (the harness wraps the engine's ``_fault_repair``): a
  sticky cell, which drives a page through strikes into quarantine.

An entry may also be a callable ``spec(engine) -> location``.

Unlike the reference, which corrupts host copies and writes them back,
the flips here XOR the stored byte on the device in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.residency import map_resident

__all__ = ["FaultSpec", "inject_faults", "flip_weight_bit", "flip_kv_bit"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str                  # "weight" | "kv" | "kv_sticky"
    bit: int = 0x01            # XOR mask applied to the stored byte
    channel: int = 0           # residue channel (weight) / plane lane (kv)
    index: int = 0             # flat element index within the channel plane
    leaf: int = 0              # which resident weight leaf (kind="weight")
    which: str = "k"           # "k" | "v" pool side (kind="kv")
    at: tuple[int, ...] | None = None  # multi-index alternative to ``index``

    def __post_init__(self):
        if self.kind not in ("weight", "kv", "kv_sticky"):
            raise ValueError(f"kind must be 'weight', 'kv' or 'kv_sticky', "
                             f"got {self.kind!r}")
        if self.kind in ("kv", "kv_sticky") and self.which not in ("k", "v"):
            raise ValueError(f"which must be 'k' or 'v', got {self.which!r}")
        if not 0 < self.bit <= 0xFF:
            raise ValueError(f"bit must be a nonzero byte mask, got "
                             f"{self.bit:#x}")


def _flip_planes(planes: torch.Tensor, channel_axis: int, channel: int,
                 index: int, at: tuple[int, ...] | None,
                 bit: int) -> tuple[int, ...]:
    """XOR ``bit`` into one stored byte in place; returns its location
    ``(channel, *at)``."""
    cf = planes.view(torch.uint8).movedim(channel_axis, 0)
    shape = tuple(cf.shape[1:])
    if at is None:
        at = np.unravel_index(index % math.prod(shape), shape)
    loc = (channel % cf.shape[0], *(int(a) for a in at))
    cf[loc] ^= bit
    return loc


def _resident_leaves(params) -> list[ResidueTensor]:
    leaves: list[ResidueTensor] = []
    map_resident(params, lambda t: leaves.append(t) if t.layout == "rns"
                 else None)
    return leaves


def flip_weight_bit(engine, spec: FaultSpec) -> tuple[int, ...]:
    """Corrupt one residue-resident weight plane byte in place."""
    targets = _resident_leaves(engine.params)
    if not targets:
        raise ValueError("engine has no residue-resident rns weights")
    victim = targets[spec.leaf % len(targets)]
    return _flip_planes(victim.planes, victim.channel_axis, spec.channel,
                        spec.index, spec.at, spec.bit)


def flip_kv_bit(engine, spec: FaultSpec) -> tuple[int, ...]:
    """Corrupt one paged-KV plane byte in place (``engine.pool.kv``)."""
    t = engine.pool.kv.k if spec.which == "k" else engine.pool.kv.v
    if not isinstance(t, ResidueTensor):
        raise ValueError("KV pool is not residue-formatted (use a rns* "
                         "kv_format)")
    return _flip_planes(t.planes, t.planes.dim() - 3, spec.channel,
                        spec.index, spec.at, spec.bit)


def _apply(engine, faults, log: list) -> None:
    for spec in faults:
        if callable(spec):
            loc = spec(engine)
        elif spec.kind == "weight":
            loc = flip_weight_bit(engine, spec)
        else:
            loc = flip_kv_bit(engine, spec)
        log.append((spec, loc))


def _reflip_sticky(engine, log: list) -> None:
    """Corrupt every fired ``kv_sticky`` fault's byte again."""
    for spec, loc in log:
        if isinstance(spec, FaultSpec) and spec.kind == "kv_sticky":
            flip_kv_bit(engine, dataclasses.replace(
                spec, kind="kv", channel=loc[0], at=loc[1:], index=0))


@contextlib.contextmanager
def inject_faults(engine, faults, *,
                  after_steps: int = 1) -> Iterator[list]:
    """Arm ``engine`` to take ``faults`` mid-decode.

    The next decode segment is split at ``after_steps`` emitted tokens: the
    first part runs clean, the bit flips land, and the rest of the segment
    continues from the same state (token, positions, budgets), so a
    fault-free engine would give the same tokens.  Yields a log of
    ``(FaultSpec, location)`` tuples, filled when the faults fire.  Later
    segments run unpatched.
    """
    orig = engine._dispatch_segment
    orig_repair = engine._fault_repair
    log: list = []
    armed = {"live": True}
    sticky = any(isinstance(f, FaultSpec) and f.kind == "kv_sticky"
                 for f in faults)

    def patched_repair(layers, tabs_np, slots):
        # sticky cell: the repair rewrites the byte and it flips right back
        ledger = orig_repair(layers, tabs_np, slots)
        if log:
            _reflip_sticky(engine, log)
        return ledger

    def patched(tok0, pos0, eos_vec, done0, remaining, tabs, seg,
                temperature, generator, stop_on_finish=False):
        if not armed["live"]:
            return orig(tok0, pos0, eos_vec, done0, remaining, tabs, seg,
                        temperature, generator, stop_on_finish)
        armed["live"] = False
        k = min(int(after_steps), int(seg))
        if k <= 0:
            _apply(engine, faults, log)
            return orig(tok0, pos0, eos_vec, done0, remaining, tabs, seg,
                        temperature, generator, stop_on_finish)
        buf1, steps1, done1 = orig(tok0, pos0, eos_vec, done0, remaining,
                                   tabs, k, temperature, generator,
                                   stop_on_finish)
        _apply(engine, faults, log)
        if steps1 >= int(seg) or bool(done1.all()):
            return buf1, steps1, done1
        tok2 = torch.as_tensor(buf1[:, steps1 - 1:steps1],
                               device=engine.device)
        buf2, steps2, done2 = orig(
            tok2, np.asarray(pos0) + steps1, eos_vec, done1,
            np.asarray(remaining) - steps1, tabs, int(seg) - steps1,
            temperature, generator, stop_on_finish)
        return (np.concatenate([buf1, buf2], axis=1), steps1 + steps2,
                done2)

    engine._dispatch_segment = patched
    if sticky:
        engine._fault_repair = patched_repair
    try:
        yield log
    finally:
        engine._dispatch_segment = orig
        if sticky:
            engine._fault_repair = orig_repair
