"""BENCHMARK.json against its files and its contract: every cell, metric
and configuration resolves to its own files by name, every per-layer
metric's cells report the end-to-end metric it moves, and nothing the
benchmark runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from harness import main

BENCH = json.loads((main.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = main.load_cell(cell)
    assert c.chips == 1
    assert (main.PERF / "harness" / "drivers" /
            f"{c.workload['driver']}.py").exists()
    assert (main.PERF / "reference" /
            f"{c.config['reference']}.py").exists()
    assert (main.PERF / "generators" / f"{c.mix['kind']}.py").exists()
    if "family" in c.config:
        assert (main.PERF / "families" /
                f"{c.config['family']}.py").exists()
    assert set(c.workload["limits"]) and all(
        v >= 0 for v in c.workload["limits"].values())
    kinds = {m["name"] for m in c.metrics.values() if "layer" not in m}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert any("layer" in m for m in c.metrics.values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves(metric):
    entry = next(m for m in METRICS if m["name"] == metric)
    assert NAME.match(metric) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert callable(main.reader(metric))
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS
    if "layer" in entry:
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((main.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"]
    assert data["reduced"] == cfg["reduced"]
    widths = re.compile(r"(hidden|intermediate|latent|state|head|_dim$|"
                        r"_rank$|expert)")
    assert not any(widths.search(k) for k in cfg["reduced"])
    assert sum(1 for c in BENCH["configs"] if c["file"] == cfg["file"]) == 1


def test_names_unique():
    for group in (CELLS, [m["name"] for m in METRICS],
                  [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_reference_imports_nothing_of_the_program():
    for path in (main.PERF / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "harness"), (path, n)


def test_no_forbidden_module_after_a_tiny_run():
    """A tiny run of every driver in a fresh process loads neither JAX nor
    the JAX package (top-level names compared whole)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import tiny\n"
        "from harness import main\n"
        "for n in %r: tiny.run(tiny.tiny_cell(n), seconds=0.3)\n"
        "print(main.forbidden_modules())\n" % (
            str(main.PERF), str(main.ROOT / "src"),
            str(main.PERF / "tests"), ["qwen3-8b.prefill", "vgg16-cifar.rns"]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=main.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "repro_torch" not in main.FORBIDDEN


def test_guard_compares_whole_names():
    sys.modules["reproducible_fake"] = sys
    try:
        assert "reproducible_fake" not in main.forbidden_modules()
    finally:
        del sys.modules["reproducible_fake"]


def test_run_without_card_prints_no_result(tmp_path):
    """With no CUDA device the command exits non-zero and prints nothing on
    standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(main.PERF / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=main.ROOT)
    assert out.returncode != 0 and out.stdout == ""
