"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, drivers and readers, with the widths, depths and mixes made tiny."""
from __future__ import annotations

from harness import main

TINY_DECODER = dict(hidden_size=64, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, intermediate_size=96,
                    vocab_size=512, num_hidden_layers=2)
TINY_CNN = [["conv", 8, 3, 1], ["pool", 2], ["conv", 8, 3, 1], ["pool", 2],
            ["fc", 16], ["fc", 10]]


def tiny_cell(name: str) -> main.Cell:
    cell = main.load_cell(name)
    wl, mix = cell.workload, cell.mix
    if wl["driver"] == "serve":
        cell.config.update(TINY_DECODER)
        slots = 4
        mix.update(job_size=16, strata=4,
                   prompt={"dist": "loguniform", "lo": 8, "hi": 64})
        wl.update(slots=slots, warm=dict(wl["warm"], requests=slots),
                  check=dict(wl["check"], admission=1))
    else:
        cell.config.update(layers=TINY_CNN)
        mix.update(batch=2, pool_batches=2)
    return cell


def run(cell: main.Cell, seed: int = 2**33 + 5, seconds: float = 1.5,
        trace: bool = False, **kw) -> main.Run:
    return main.driver(cell).run(cell, seed=seed, seconds=seconds,
                                 trace=trace, device="cpu", t_start=0.0,
                                 **kw)
