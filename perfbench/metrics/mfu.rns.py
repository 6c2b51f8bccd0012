"""Model FLOPs of the window's work over the window at the bf16 dense
peak, %."""
from harness import readers


def read(run):
    return readers.mfu(run)
