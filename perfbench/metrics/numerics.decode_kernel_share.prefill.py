"""Output elements the residue runner decoded through the reverse
conversion kernel (B9) over all it decoded in the profiled slice, from the
program's counters ``numerics.decode_kernel`` and
``numerics.decode_eager``, %."""
from harness import spans


def read(run):
    if not run.profile:
        return None
    counters = (spans.snapshot() or {}).get("counters", {})
    kernel = counters.get("numerics.decode_kernel", 0)
    total = kernel + counters.get("numerics.decode_eager", 0)
    if total <= 0:
        return None
    return 100.0 * kernel / total
