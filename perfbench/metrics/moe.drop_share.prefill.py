"""(Token, slot) pairs the expert layers dropped past their capacity over
the real pairs they routed in the profiled slice, from the program's
counters ``moe.dropped`` and ``moe.slots``, %."""
from harness import spans


def read(run):
    if not run.profile:
        return None
    counters = (spans.snapshot() or {}).get("counters", {})
    slots = counters.get("moe.slots", 0)
    if slots <= 0:
        return None
    return 100.0 * counters.get("moe.dropped", 0) / slots
