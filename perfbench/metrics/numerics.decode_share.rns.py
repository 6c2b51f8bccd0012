"""Stream seconds in the program's ``numerics.decode`` spans (each K
segment's MRC or SD decode, the segment sum, the rescale) over the
profiled slice, %."""
from harness import spans


def read(run):
    return spans.share(run, "numerics.decode")
