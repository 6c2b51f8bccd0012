"""B1 (rns_matmul): counted work at the peaks over its device time, %.
In this cell the host paces the launches that each call's CUDA events
bracket, so the device time includes the host's gaps inside a call."""
from harness import readers


def read(run):
    return readers.roofline(run, "rns_matmul")
