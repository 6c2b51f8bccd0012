"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.

The cell's workload file names its configuration, its traffic mix and its
driver (``harness/drivers/<driver>.py``); ``BENCHMARK.json`` names the
metrics it reports, and each metric's reader is ``metrics/<name>.py``.
The driver builds the system under test from the configuration, warms it
up, runs the window, and judges what the window produced against the
plain reference; the readers turn its record into numbers.

The result is the last line of standard output (one JSON object); the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable

PERF = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = PERF.parent                              # the checkout

# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict          # perfbench/workloads/<cell>.json
    config: dict            # perfbench/configs/<config>.json
    mix: dict               # perfbench/traffic/<mix>.json, read by
    #                         perfbench/generators/<its kind>.py
    metrics: dict[str, dict]  # name -> BENCHMARK.json entry, this cell's


@dataclasses.dataclass
class Run:
    """What a driver hands back: the raw counts the metric readers read."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    counts: dict[str, float]          # tokens, images, rows, steps ...
    numbers: dict[str, float]         # the correctness numbers
    limits: dict[str, float]
    memory_peak_bytes: int
    ops: dict[str, dict] | None = None    # OpTimer.summary()
    profile: dict | None = None           # ProfilerSlice.result

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.numbers)
                and all(math.isfinite(v) and v <= self.limits[k]
                        for k, v in self.numbers.items()))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None,
              perf: Path = PERF) -> Cell:
    """Resolve a cell and its files by name."""
    bench = bench if bench is not None else load_json(perf.parent /
                                                      "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(perf / "workloads" / f"{name}.json")
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: workload file and BENCHMARK.json name "
                         f"different configurations or mixes")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(perf.parent / cfg_entry["file"])
    mix = load_json(perf / "traffic" / f"{entry['traffic']}.json")
    metrics = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if name in m.get("workloads", [name]):
            metrics[m["name"]] = m
    return Cell(name, entry["chips"], wl, config, mix, metrics)


def reader(name: str, perf: Path = PERF) -> Callable[[Run], float | None]:
    """``metrics/<name>.py``'s ``read``."""
    path = perf / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(cell: Cell):
    return importlib.import_module(
        f"harness.drivers.{cell.workload['driver']}")


def family(cell: Cell):
    """``families/<family>.py``, how the harness builds the program's model
    for the cell's configuration."""
    return importlib.import_module(f"families.{cell.config['family']}")


def generator(cell: Cell):
    """``generators/<kind>.py``, the generator of the cell's mix."""
    return importlib.import_module(f"generators.{cell.mix['kind']}")


def metrics_of(cell: Cell, run: Run, trace: bool) -> dict[str, dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced);
    a reader that finds nothing to read leaves its metric out."""
    out = {}
    for name, m in cell.metrics.items():
        if (m.get("layer") is not None) != trace:
            continue
        v = reader(name)(run)
        if v is not None:
            out[name] = {"value": v, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result_line(cell: Cell, run: Run, trace: bool, device: dict) -> dict:
    res: dict[str, Any] = {
        "correct": run.correct, "attempted": run.attempted,
        "failed": run.failed, "metrics": metrics_of(cell, run, trace),
        "device": device}
    if trace and run.profile is not None:
        res["device"] = {**device, "busy_s": run.profile["busy_s"],
                         "window_s": run.profile["window_s"]}
        res["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    res["checks"] = {k: {"value": v, "limit": run.limits[k]}
                     for k, v in run.numbers.items()}
    return res


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    run = driver(cell).run(cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda",
                           t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded after the window: "
              f"{found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    res = result_line(cell, run, bool(args.trace), device)
    print(f"perfbench: {cell.name} seed={args.seed} on {power_limit()}; "
          f"window {run.window_s:.3f}s, set-up {run.setup_s:.3f}s, "
          f"counts {json.dumps(run.counts)}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
