"""Padded rows over all rows of the window's admission prefills, %."""


def read(run):
    rows = run.counts.get("prefill_rows", 0)
    if rows <= 0:
        return None
    return 100.0 * (1.0 - run.counts["prompt_tokens"] / rows)
