"""Stream seconds in the program's expert-layer spans ``moe.route`` (router
product, scores, top-k, gates), ``moe.dispatch`` (placement, the scatter
into the (E, C, d) buffers) and ``moe.combine`` (the gather back, gate
weighting, k-sum, the shared experts' add) over the profiled slice, %."""
from harness import spans


def read(run):
    parts = [spans.share(run, n)
             for n in ("moe.route", "moe.dispatch", "moe.combine")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
