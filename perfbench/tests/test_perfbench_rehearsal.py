"""Every driver end to end on the CPU at a tiny size, through the port's
plain versions: the window runs, the readers read, and the program's
outputs equal the reference's."""
from __future__ import annotations

import pytest
import tiny

from harness import main

CELLS = ["qwen3-8b.prefill", "vgg16-cifar.rns", "vgg16-cifar.sdrns"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(cell):
    c = tiny.tiny_cell(cell)
    run = tiny.run(c, seed=2**40 + 3)
    assert run.correct, run.numbers
    assert all(v == 0.0 for v in run.numbers.values())
    assert run.window_s > 0 and run.setup_s > 0
    res = main.result_line(c, run, False, {"platform": "cpu"})
    e2e = {n for n, m in c.metrics.items() if "layer" not in m}
    assert set(res["metrics"]) == e2e
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["qwen3-8b.prefill", "vgg16-cifar.rns"])
def test_tiny_traced_run(cell):
    c = tiny.tiny_cell(cell)
    run = tiny.run(c, seed=7, trace=True)
    assert run.correct and run.profile is not None
    res = main.result_line(c, run, True, {"platform": "cpu"})
    assert "breakdown" in res and res["device"]["window_s"] > 0
    assert all("layer" in c.metrics[n] for n in res["metrics"])


def test_same_seed_same_traffic():
    cell = tiny.tiny_cell("qwen3-8b.prefill")
    mix, gen = cell.mix, main.generator(cell)
    a = gen.job(mix, 2**35 + 1, 0, 512)
    b = gen.job(mix, 2**35 + 1, 0, 512)
    c = gen.job(mix, 2**35 + 2, 0, 512)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]
    # another seed: the same sizes in every group of arrivals, in another
    # order, with other ids
    m = mix["strata"]
    for g in range(0, len(a), m):
        assert sorted((len(r.tokens), r.max_new) for r in a[g: g + m]) == \
            sorted((len(r.tokens), r.max_new) for r in c[g: g + m])
    assert [r.tokens.tolist() for r in a] != [r.tokens.tolist() for r in c]
