"""Share of the profiled slice with nothing running on the device, %."""
from harness import readers


def read(run):
    return readers.device_idle(run)
