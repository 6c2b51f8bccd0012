"""Readings of the program's own spans and counters
(``repro_torch.tracing``) for the metric readers.  Each returns None where
the run has nothing to read: an untraced run, a program without spans of
its own, a span or counter the profiled slice never reached."""
from __future__ import annotations

import importlib


def snapshot() -> dict | None:
    """The program's aggregate of the most recent profiled session."""
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ModuleNotFoundError as e:
        if e.name != "repro_torch.tracing":
            raise
        return None
    return tracing.snapshot()


def share(run, name: str) -> float | None:
    """100 x the span's stream seconds over the profiled slice's
    ``window_s``, %.  On a stream the device keeps busy that is device
    time; on one the host paces it also counts the idle the host leaves
    inside the span."""
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    snap = snapshot()
    rec = (snap or {}).get("spans", {}).get(name)
    if not rec or rec["calls"] <= 0:
        return None
    return 100.0 * rec["stream_s"] / p["window_s"]


def pad_share(run) -> float | None:
    """Padded rows over all rows of the slice's admission prefills, as the
    engine counts them, %."""
    if not run.profile:
        return None
    counters = (snapshot() or {}).get("counters", {})
    rows = counters.get("engine.prefill_rows", 0)
    if rows <= 0:
        return None
    return 100.0 * (1.0 - counters.get("engine.prompt_tokens", 0) / rows)
