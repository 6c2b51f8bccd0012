"""Expert buffer rows no (token, slot) pair filled over all the rows the
expert layers ran (E x C a call) in the profiled slice, from the
program's counters ``moe.capacity_rows``, ``moe.slots`` and
``moe.dropped``, %: the expert work spent on empty rows."""
from harness import spans


def read(run):
    if not run.profile:
        return None
    counters = (spans.snapshot() or {}).get("counters", {})
    rows = counters.get("moe.capacity_rows", 0)
    if rows <= 0:
        return None
    filled = counters.get("moe.slots", 0) - counters.get("moe.dropped", 0)
    return 100.0 * (rows - filled) / rows
