"""Serving telemetry (the counters of ``repro/serving/stats.py``: the
pool's prefix-cache counters, the corruption counters of
:class:`FaultStats`, the speculative counters of :class:`SpecStats` and the
scheduler's per-request fields included)."""
from __future__ import annotations

import dataclasses

__all__ = ["FaultStats", "PoolStats", "SpecStats", "RequestStats",
           "EngineStats"]


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
    prefix_hits: int = 0     # prompt pages served from the prefix cache
    prefill_skips: int = 0   # whole-prompt cache hits (no prefill pass)
    evictions: int = 0       # cached-free pages reclaimed

    def snapshot(self) -> "PoolStats":
        return dataclasses.replace(self)


@dataclasses.dataclass
class SpecStats:
    """Speculative-decoding telemetry.

    One verify step is one batched target call over ``k + 1`` rows a slot;
    it emits 1 to ``k + 1`` tokens per live slot, so ``mean_accepted_len``
    above 1 is what drafting buys.
    """

    proposed: int = 0       # draft tokens proposed (k per live slot a step)
    accepted: int = 0       # ... accepted by the greedy verify rule
    emitted: int = 0        # tokens emitted by the speculative segment
    verify_steps: int = 0   # batched verify steps (target calls)
    blocks: int = 0         # accepted blocks emitted (live slot-steps)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of the proposed draft tokens the target accepted."""
        return self.accepted / max(self.proposed, 1)

    @property
    def mean_accepted_len(self) -> float:
        """Tokens emitted per accepted block (1.0: drafting bought
        nothing)."""
        return self.emitted / max(self.blocks, 1)

    def snapshot(self) -> "SpecStats":
        return dataclasses.replace(self)


@dataclasses.dataclass
class RequestStats:
    """Per-request telemetry: one ``generate()`` batch, or one request of
    the scheduler (``Request.stats``)."""

    decode_steps: int = 0        # decode steps this batch ran
    decode_dispatches: int = 0   # host-driven decode step calls
    pages_allocated: int = 0     # KV pages allocated for this batch
    pages_freed: int = 0         # KV pages released at the end
    prefix_hits: int = 0         # prompt pages reused from the prefix cache
    prefill_skipped: bool = False  # whole prompt cached: no prefill pass
    latency_s: float = 0.0       # host clock: serve() entry -> request done
    prefill_s: float = 0.0       # host clock: prompt in -> prefill logits
    #                              on the host (the copy synchronizes)
    decode_s: float = 0.0        # host clock: prefill logits -> all tokens
    #                              on the host (scatter + decode steps)
    faults_detected: int = 0     # corruption the scrub saw this batch
    faults_corrected: int = 0    # ... and repaired before decoding on
    recomputes: int = 0          # times a slot was recomputed after an
    #                              unrepairable fault
    spec: SpecStats | None = None  # the speculative segment's counters


@dataclasses.dataclass
class EngineStats:
    """Engine-lifetime telemetry (``engine.stats``)."""

    decode_steps: int = 0
    decode_dispatches: int = 0
    # channel_shard plans that fell back to the gathered layout (C not
    # dividing the tensor axis, no moduli set, or a set past the int32
    # partial-CRT bound) since the engine was made; the port resolves a
    # plan at every matmul call, so this counts calls.  Mirrors
    # runners.fallback_gather_count()
    fallback_gathers: int = 0
    pool: PoolStats | None = None
    faults: FaultStats = dataclasses.field(default_factory=FaultStats)
    spec: SpecStats | None = None   # set when the engine runs with spec=
