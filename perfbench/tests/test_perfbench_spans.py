"""The per-layer metrics read from the program's own spans and counters
(``harness/spans.py``), on tiny traced runs on the CPU."""
from __future__ import annotations

import importlib

import pytest
import tiny

from harness import main, spans

SHARES = ("numerics.encode_share", "numerics.decode_share",
          "numerics.weight_encode_share", "engine.scatter_share")


def _new(cell: main.Cell) -> list[str]:
    """The cell's metrics that ``harness/spans.py`` reads."""
    return [n for n in cell.metrics
            if n.startswith(SHARES + ("engine.pad_share",))]


@pytest.mark.parametrize("cell, n", [("qwen3-8b.prefill", 4),
                                     ("vgg16-cifar.rns", 3)])
def test_traced_run_reports_the_span_metrics(cell, n):
    c = tiny.tiny_cell(cell)
    run = tiny.run(c, seed=2**36 + 11, trace=True)
    assert run.correct
    res = main.result_line(c, run, True, {"platform": "cpu"})
    new = _new(c)
    assert len(new) == n and set(new) <= set(res["metrics"])
    for name in new:
        assert 0.0 <= res["metrics"][name]["value"] <= 100.0, name
    shares = [res["metrics"][name]["value"] for name in new
              if name.startswith(SHARES)]
    assert shares and sum(shares) <= 100.0
    if cell == "qwen3-8b.prefill":
        # the slice spans the whole window: the tiny window (1.5 s) ends
        # before the workload's slice (10 s)
        assert run.counts["prefill_rows"] > 0
        assert res["metrics"]["engine.pad_share.prefill"]["value"] == \
            pytest.approx(res["metrics"]["sched.pad_share.prefill"]["value"])


def test_untraced_run_reads_nothing():
    c = tiny.tiny_cell("vgg16-cifar.rns")
    run = tiny.run(c, seed=5, seconds=0.3)
    assert all(main.reader(n)(run) is None for n in _new(c))


def test_a_program_without_spans_reads_nothing(monkeypatch):
    c = tiny.tiny_cell("qwen3-8b.prefill")
    run = tiny.run(c, seed=9, trace=True)
    real = importlib.import_module

    def without(name, *a, **k):
        if name == "repro_torch.tracing":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return real(name, *a, **k)
    monkeypatch.setattr(importlib, "import_module", without)
    assert spans.snapshot() is None
    assert all(main.reader(n)(run) is None for n in _new(c))
