"""Stream seconds in the program's ``engine.scatter`` spans (prefill K and
V into the KV pages) over the profiled slice, %."""
from harness import spans


def read(run):
    return spans.share(run, "engine.scatter")
