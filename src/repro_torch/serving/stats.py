"""Serving telemetry (the counters of ``repro/serving/stats.py`` that the
ported paged path keeps, the corruption counters of :class:`FaultStats`
included)."""
from __future__ import annotations

import dataclasses

__all__ = ["FaultStats", "PoolStats", "RequestStats", "EngineStats"]


@dataclasses.dataclass
class FaultStats:
    """Redundant-residue corruption telemetry (engine lifetime)."""

    detected: int = 0        # residue inconsistencies observed (elements)
    corrected: int = 0       # faulty channels reconstructed (elements)
    weight_scrubs: int = 0   # scrub passes over resident weight planes
    kv_scrubs: int = 0       # scrub passes over resident KV pages
    syndromes: int = 0       # faulty elements the in-kernel syndrome
    #                          reduction flagged (before repair)
    uncorrected: int = 0     # detected elements a repair could not fix
    replays: int = 0         # decode segments replayed after a repair
    recomputes: int = 0      # requests recomputed after an unrepairable
    #                          fault (pages released, prefill re-scattered)
    pages_quarantined: int = 0   # pages retired from the pool for good


@dataclasses.dataclass
class PoolStats:
    """KV page-pool telemetry (lifetime of the pool)."""

    pages_allocated: int = 0
    pages_freed: int = 0

    def snapshot(self) -> "PoolStats":
        return dataclasses.replace(self)


@dataclasses.dataclass
class RequestStats:
    """Per-generate() telemetry."""

    decode_steps: int = 0        # decode steps this batch ran
    decode_dispatches: int = 0   # host-driven decode step calls
    pages_allocated: int = 0     # KV pages allocated for this batch
    pages_freed: int = 0         # KV pages released at the end
    prefill_s: float = 0.0       # host clock: prompt in -> prefill logits
    #                              on the host (the copy synchronizes)
    decode_s: float = 0.0        # host clock: prefill logits -> all tokens
    #                              on the host (scatter + decode steps)
    faults_detected: int = 0     # corruption the scrub saw this batch
    faults_corrected: int = 0    # ... and repaired before decoding on
    recomputes: int = 0          # times a slot was recomputed after an
    #                              unrepairable fault


@dataclasses.dataclass
class EngineStats:
    """Engine-lifetime telemetry (``engine.stats``)."""

    decode_steps: int = 0
    decode_dispatches: int = 0
    pool: PoolStats | None = None
    faults: FaultStats = dataclasses.field(default_factory=FaultStats)
