"""Reductions the metric readers (``metrics/<name>.py``) share.  Each
returns None where the run has nothing to read (an untraced run, an op the
window never called), and the harness then leaves the metric out."""
from __future__ import annotations

from yardstick import peaks


def rate(run, count: str) -> float | None:
    """A count of the window over the window's seconds."""
    if run.window_s <= 0:
        return None
    return run.counts[count] / run.window_s


def roofline(run, op: str) -> float | None:
    """The op's share of its roofline, %: the least time its counted work
    needs at the card's peaks over its device time (CUDA events around each
    call), summed over the window's calls."""
    rec = (run.ops or {}).get(op)
    if not rec or rec["device_s"] <= 0:
        return None
    return 100.0 * rec["least_s"] / rec["device_s"]


def mfu(run) -> float | None:
    """Model FLOPs of the window's work over the window and the bf16 dense
    peak, %."""
    if run.window_s <= 0 or run.counts.get("model_flops", 0) <= 0:
        return None
    return 100.0 * run.counts["model_flops"] / run.window_s / \
        peaks.PEAK_FLOPS_BF16


def device_idle(run) -> float | None:
    """The share of the profiled slice with nothing running on the device,
    %."""
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - p["busy_s"] / p["window_s"])


def eager_share(run) -> float | None:
    """The share of the slice's device time outside the port's own
    kernels (eager PyTorch ops, copies, fills), %."""
    p = run.profile
    if not p or p["device_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["port_kernel_s"] / p["device_s"])
