"""B6 (sdrns_matmul): counted work at the peaks over its device time, %."""
from harness import readers


def read(run):
    return readers.roofline(run, "sdrns_matmul")
