"""Share of the profiled slice's device time outside the port's own
kernels (the eager encode, MRC decode, quantize, norms, im2col), %."""
from harness import readers


def read(run):
    return readers.eager_share(run)
