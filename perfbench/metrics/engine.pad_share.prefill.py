"""Padded rows over all rows of the profiled slice's admission prefills,
from the engine's own counters (``engine.prefill_rows``,
``engine.prompt_tokens``), %."""
from harness import spans


def read(run):
    return spans.pad_share(run)
