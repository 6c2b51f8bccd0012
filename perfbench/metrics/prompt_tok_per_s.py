"""Prompt tokens prefilled in the window (padding not counted) over its
seconds."""
from harness import readers


def read(run):
    return readers.rate(run, "prompt_tokens")
