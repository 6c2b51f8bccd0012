"""Serving telemetry (the counters of ``repro/serving/stats.py`` that the
ported paged path keeps)."""
from __future__ import annotations

import dataclasses

__all__ = ["PoolStats", "RequestStats", "EngineStats"]


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


@dataclasses.dataclass
class EngineStats:
    """Engine-lifetime telemetry (``engine.stats``)."""

    decode_steps: int = 0
    decode_dispatches: int = 0
    pool: PoolStats | None = None
