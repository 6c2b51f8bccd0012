"""What a traced run reads: the registered kernel ops timed on the device,
and a profiler slice of the window.

* :class:`OpTimer` takes the numerics registry's ``OBSERVER`` slot: every
  registered op call is bracketed by two CUDA events, and its work is
  counted with the benchmark's frozen work functions from the arguments
  the registry hands the implementation.  Events are read after the
  window, so nothing inside it waits on the device.
* :class:`ProfilerSlice` runs ``torch.profiler`` (CPU and CUDA activity)
  over a slice of the window and reduces its events: busy time (the union
  of device activity), device time by name, device time in the port's own
  kernels (their names read from the program's CUDA sources), and the
  device's idle gaps labelled by the harness span the host was in.
"""
from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path
from typing import Any, Callable

import torch

from yardstick import peaks
from yardstick.work import COSTS, deferred_work

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*[<(]")


def port_kernel_names(csrc: Path) -> list[str]:
    """The names of the ``__global__`` functions in the program's CUDA
    sources."""
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(p.read_text()))
    return sorted(names)


class OpTimer:
    """Device time and counted work of each registered op (see module)."""

    def __init__(self):
        self.calls: list[tuple[str, Any, Any, Callable]] = []
        self.on = False

    def __call__(self, op: str, fn: Callable, /, *args, **kwargs):
        if not self.on or op not in COSTS:
            return fn(*args, **kwargs)
        work = deferred_work(op, args, kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.calls.append((op, start, end, work))
        return out

    @contextlib.contextmanager
    def installed(self, registry):
        outer = registry.OBSERVER
        registry.OBSERVER = self
        try:
            yield self
        finally:
            registry.OBSERVER = outer

    def summary(self) -> dict[str, dict[str, float]]:
        """``{op: {"calls", "device_s", "least_s", "ops", "bytes"}}``."""
        torch.cuda.synchronize()
        out: dict[str, dict[str, float]] = {}
        for op, start, end, work in self.calls:
            w = work()
            rec = out.setdefault(op, {"calls": 0, "device_s": 0.0,
                                      "least_s": 0.0, "ops": 0, "bytes": 0})
            rec["calls"] += 1
            rec["device_s"] += start.elapsed_time(end) / 1e3
            rec["least_s"] += peaks.least_seconds(w.ops, w.bytes, w.kind)
            rec["ops"] += w.ops
            rec["bytes"] += w.bytes
        return out


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans: list[tuple[int, int, str]], t: int) -> str | None:
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


class ProfilerSlice:
    """``torch.profiler`` over a slice of the window (see module)."""

    def __init__(self, kernel_names: list[str]):
        self.kernel_names = kernel_names
        self.prof = None
        self.result: dict[str, Any] | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.result is None

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.result = self._reduce(window_s)
        self.prof = None

    def _reduce(self, window_s: float) -> dict[str, Any]:
        dev, spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns()
            b = a + e.duration_ns()
            on_device = e.device_type() == cuda
            if e.is_user_annotation():
                if not on_device:     # the device-side copy of a span
                    spans.append((a, b, e.name()))
            elif on_device:
                dev.append((a, b, e.name()))
        busy_iv = _merge([(a, b) for a, b, _ in dev])
        busy_ns = sum(b - a for a, b in busy_iv)
        by_name: dict[str, int] = {}
        port_ns = 0
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0) + (b - a)
            if any(k in name for k in self.kernel_names):
                port_ns += b - a
        dev_ns = sum(by_name.values())
        gaps: dict[str, int] = {}
        for (_, b0), (a1, _) in zip(busy_iv, busy_iv[1:]):
            label = _innermost(spans, (b0 + a1) // 2) or "host"
            gaps[label] = gaps.get(label, 0) + (a1 - b0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": window_s, "busy_s": busy_ns / 1e9,
                "device_s": dev_ns / 1e9, "port_kernel_s": port_ns / 1e9,
                "device_ops": [[n, v / 1e9] for n, v in top],
                "idle_gaps": [[n, v / 1e9] for n, v in top_gaps]}


@contextlib.contextmanager
def span(name: str, on: bool):
    """A named host span the profiler records (nothing when off)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield
