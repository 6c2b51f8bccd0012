"""Readings for a cell's correctness limits, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 8]

For each seed, one run of the program with a short window at the cell's
own load, judged against the plain reference (the lower readings); for
each control seed, the control: the reference one precision step below
the configuration's (``bits - 1``) put in the program's place, on the
same prompts and served tokens (the upper readings).  One JSON line a
reading.  It needs the card, as the cell does.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import main  # noqa: E402


def readings(cell_name: str, seeds: list[int], control_seeds: list[int],
             seconds: float, device: str = "cuda"):
    import torch
    cell = main.load_cell(cell_name)
    drv = main.driver(cell)
    bits = cell.config["port"]["bits"]
    for seed in seeds:
        keep: dict = {}
        kw = {"keep": keep} if cell.workload["driver"] == "serve" else {}
        run = drv.run(cell, seed=seed, seconds=seconds, trace=False,
                      device=device, t_start=time.perf_counter(), **kw)
        yield {"cell": cell_name, "seed": seed, "side": "program",
               "numbers": run.numbers, "correct": run.correct,
               "window_s": run.window_s, "counts": run.counts}
        if seed in control_seeds:
            dev = torch.device(device)
            if cell.workload["driver"] == "serve":
                ctl = drv.control(cell, seed, dev, keep["captures"])
            else:
                ctl = drv.control(cell, seed, dev, bits - 1)
            yield {"cell": cell_name, "seed": seed, "side": "control",
                   "numbers": ctl}
        del keep, run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def main_(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    for rec in readings(a.workload, seeds, ctl, a.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
