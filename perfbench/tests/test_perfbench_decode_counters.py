"""The reverse conversion's counters (``numerics.decode_kernel``,
``numerics.decode_eager``) read as ``numerics.decode_kernel_share.*`` on
tiny traced runs on the CPU, where every decode is the plain version."""
from __future__ import annotations

import importlib

import pytest
import tiny

from harness import main, spans


def _shares(cell: main.Cell) -> list[str]:
    return [n for n in cell.metrics
            if n.startswith("numerics.decode_kernel_share")]


@pytest.mark.parametrize("cell", ["qwen3-8b.prefill", "vgg16-cifar.rns"])
def test_traced_run_reads_the_share(cell):
    c = tiny.tiny_cell(cell)
    run = tiny.run(c, seed=2**36 + 13, trace=True)
    assert run.correct
    res = main.result_line(c, run, True, {"platform": "cpu"})
    names = _shares(c)
    assert len(names) == 1
    counters = spans.snapshot()["counters"]
    assert counters["numerics.decode_eager"] > 0
    assert "numerics.decode_kernel" not in counters
    assert res["metrics"][names[0]]["value"] == 0.0


def test_sdrns_and_untraced_runs_read_nothing():
    assert _shares(tiny.tiny_cell("vgg16-cifar.sdrns")) == []
    c = tiny.tiny_cell("vgg16-cifar.rns")
    run = tiny.run(c, seed=7, seconds=0.3)
    assert all(main.reader(n)(run) is None for n in _shares(c))


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    c = tiny.tiny_cell("qwen3-8b.prefill")
    run = tiny.run(c, seed=9, trace=True)
    real = importlib.import_module

    def without(name, *a, **k):
        if name == "repro_torch.tracing":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return real(name, *a, **k)
    monkeypatch.setattr(importlib, "import_module", without)
    assert all(main.reader(n)(run) is None for n in _shares(c))
