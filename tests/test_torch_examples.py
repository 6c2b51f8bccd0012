"""The port's serving and training examples (``examples/torch_serve_lm.py``,
``examples/torch_train_lm.py``) run on the CPU at reduced size, exit 0
and print their summary lines; neither imports ``jax`` or ``repro``."""
from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
PAT = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)


def _run(name, *args):
    path = os.path.join(ROOT, "examples", name)
    with open(path) as f:
        assert not PAT.search(f.read()), name
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(
        ROOT, "src")), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, path, "--device", "cpu", *args],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_serve_lm(system):
    out = _run("torch_serve_lm.py", "--system", system, "--max-new", "8")
    assert f"system={system} B=4: 32 tokens" in out
    assert "greedy decode deterministic across calls: True" in out


def test_train_lm(tmp_path):
    out = _run("torch_train_lm.py", "--steps", "12", "--system", "rns",
               "--ckpt-dir", str(tmp_path / "ckpt"))
    m = re.search(r"loss: start ([\d.]+) -> min ([\d.]+) -> final", out)
    assert m and float(m.group(2)) < float(m.group(1)), out
    assert "device=cpu" in out
    # a rerun with --resume finds the last checkpoint and has nothing to do
    out = _run("torch_train_lm.py", "--steps", "12", "--resume",
               "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "nothing to do" in out
