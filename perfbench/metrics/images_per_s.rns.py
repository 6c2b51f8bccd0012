"""Images classified in the window over its seconds."""
from harness import readers


def read(run):
    return readers.rate(run, "images")
