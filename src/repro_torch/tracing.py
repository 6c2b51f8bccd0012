"""Spans and counters at the port's numerics and engine boundaries.

Tracing is on while a ``torch.profiler`` session records, and off
otherwise: there is no other switch.  Off, :func:`span` reads one flag and
returns a shared no-op context, and :func:`count` reads the same flag and
returns; callers that would compute a device value only to count it ask
:func:`enabled` first.

On, each span

* opens ``torch.profiler.record_function(name)``, so it sits in the
  profiler's trace beside the device's kernels, on the same clock;
* records two CUDA events on the current stream where CUDA is in use (the
  host clock otherwise);
* adds to an in-memory aggregate kept by name: ``calls``, ``host_s``,
  ``self_s`` (host seconds less those of the span's child spans) and
  ``stream_s``.  The events are read when the aggregate is read, so no
  span waits on the device.

:func:`snapshot` returns the aggregate of the most recent profiled session.
A session's aggregate is closed when :func:`snapshot` reads it after the
profiler stopped; the first span or count after that starts a new one.
A count may be a 0-d device tensor (a value the device holds, such as the
slots an expert layer dropped): it is kept on the device and summed when
:func:`snapshot` reads the aggregate, as the spans' events are read, so
counting waits on nothing.

Names are a fixed set, :data:`SPANS` and :data:`COUNTERS`; the spans do
not bracket kernels, which the profiler's device trace names itself.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "COUNTERS", "span", "count", "enabled", "snapshot"]

SPANS = frozenset({
    "numerics.encode",          # an activation to residues or digits
    "numerics.decode",          # reverse conversion, segment sum, rescale
    "numerics.weight_encode",   # a float weight's per-call encode
    "engine.admit_prefill",     # one admission, the spans below inside
    "engine.pages",             # page allocation and block tables
    "engine.prefill",           # the forward and the logits' copy out
    "engine.scatter",           # prefill K and V into the KV pages
    "moe.route",                # router product, scores, top-k, gates
    "moe.dispatch",             # placement, scatter into (E, C, d)
    "moe.combine",              # gather back, gates, k-sum, shared add
    "attn.latent",              # MLA: kv_a, its norm, kv_b, k_pe's rope
})
COUNTERS = frozenset({
    "engine.prefill_rows",      # B x S of each admission prefill
    "engine.prompt_tokens",     # the real prompt tokens among them
    "numerics.decode_kernel",   # elements rns_run decoded through B9
    "numerics.decode_eager",    # elements it decoded in eager ops
    "moe.slots",                # real (token, slot) pairs routed
    "moe.dropped",              # those past their expert's capacity
    "moe.capacity_rows",        # E x C of each expert layer's buffers
})

_OFF = contextlib.nullcontext()


class _Aggregate:
    """One session's spans and counters."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}     # calls, host, self, stream
        self.counters: dict[str, int] = {}
        self.pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] \
            = []
        self.device_counts: dict[str, list[torch.Tensor]] = {}
        self.closed = False

    def fold(self) -> None:
        """Adds the stream seconds of the spans recorded on CUDA and the
        counts held on the device."""
        for name, vals in self.device_counts.items():
            total = torch.stack([v.reshape(()).to(torch.int64)
                                 for v in vals]).sum()
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self.device_counts.clear()
        if not self.pending:
            return
        torch.cuda.synchronize()
        for name, start, end in self.pending:
            self.spans[name][3] += start.elapsed_time(end) / 1e3
        self.pending.clear()


_AGG = _Aggregate()
_STACK: list[_Span] = []


def _session() -> _Aggregate:
    global _AGG
    if _AGG.closed:
        _AGG = _Aggregate()
    return _AGG


class _Span:
    __slots__ = ("name", "rf", "start", "t0", "child")

    def __init__(self, name: str):
        if name not in SPANS:
            raise ValueError(f"unknown span {name!r}")
        self.name = name

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.child = 0.0
        _STACK.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        agg = _session()
        rec = agg.spans.setdefault(self.name, [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.child
        if self.start is None:
            rec[3] += dt
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            agg.pending.append((self.name, self.start, end))
        _STACK.pop()
        if _STACK:
            _STACK[-1].child += dt
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one of :data:`SPANS` (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def enabled() -> bool:
    """Whether spans and counts are recorded now (a profiler session
    records)."""
    return _profiler._is_profiler_enabled


def count(name: str, n: int | torch.Tensor) -> None:
    """Adds ``n`` to the counter ``name`` (one of :data:`COUNTERS`) while
    tracing is on; a tensor ``n`` (one element) is summed on its device
    when the aggregate is read."""
    if not _profiler._is_profiler_enabled:
        return
    if name not in COUNTERS:
        raise ValueError(f"unknown counter {name!r}")
    agg = _session()
    if isinstance(n, torch.Tensor):
        agg.device_counts.setdefault(name, []).append(n.detach())
        return
    agg.counters[name] = agg.counters.get(name, 0) + int(n)


def snapshot() -> dict[str, dict]:
    """``{"spans": {name: {"calls", "host_s", "self_s", "stream_s"}},
    "counters": {name: n}}`` of the most recent profiled session; read
    after the profiler stopped, it closes that session."""
    agg = _AGG
    agg.fold()
    if not _profiler._is_profiler_enabled:
        agg.closed = True
    return {"spans": {n: {"calls": int(r[0]), "host_s": r[1],
                          "self_s": r[2], "stream_s": r[3]}
                      for n, r in agg.spans.items()},
            "counters": dict(agg.counters)}
