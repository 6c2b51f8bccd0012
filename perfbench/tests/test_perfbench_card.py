"""On the card: each cell's control fails its check and the program passes
it, at the cell's own size and window, on three seeds
(``perfbench/calibrate.py``).  Several minutes a cell; run on the card with
``python -m pytest -m cuda perfbench/tests``."""
from __future__ import annotations

import pytest

import calibrate
from harness import main

BENCH = main.load_json(main.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [2**32 + 101, 2**32 + 202, 2**32 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    limits = main.load_cell(cell).workload["limits"]
    for rec in calibrate.readings(cell, SEEDS, SEEDS,
                                  seconds=BENCH["run_seconds"]):
        failed = any(v > limits[k] for k, v in rec["numbers"].items()
                     if k in limits)
        if rec["side"] == "program":
            assert rec["correct"], rec
        else:
            assert failed, rec
