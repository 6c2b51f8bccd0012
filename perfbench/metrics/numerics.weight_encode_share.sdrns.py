"""Stream seconds in the program's ``numerics.weight_encode`` spans (the
per-call quantize and encode of a float weight) over the profiled slice,
%."""
from harness import spans


def read(run):
    return spans.share(run, "numerics.weight_encode")
