"""B2 (flash_attention): counted work at the peaks over its device time, %."""
from harness import readers


def read(run):
    return readers.roofline(run, "flash_attention")
