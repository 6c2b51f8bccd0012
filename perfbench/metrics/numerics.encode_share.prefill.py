"""Stream seconds in the program's ``numerics.encode`` spans (the
activation's quantize and residue or digit encode) over the profiled
slice, %."""
from harness import spans


def read(run):
    return spans.share(run, "numerics.encode")
