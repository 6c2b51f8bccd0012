"""The dry run's train cells (``launch/dryrun.py``): the sharded train step
counted on rank 0's blocks of the (16, 16) production mesh, and
``--seq-shard`` (Megatron-SP), on reduced qwen3-8b ``train_4k`` under
``rns``.

Under SP rank 0 runs the training forward's norms and residual adds on
its sequence shard, 1/16 of the positions: the bytes counted inside them
are 1/16 of the same cell's without SP, exactly once each norm's read of
its scale (d_model f32, the same in both) is set apart.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.parallel import collectives
from torch_threads import one_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELL = ("qwen3-8b", "train_4k", "single")


def _cell(tmp, seq_shard: bool) -> tuple[dict, int, int]:
    """The cell's record, the bytes counted inside the training forward's
    norms and residual adds (the transformer's own) and the number of
    norm calls."""
    inside, norms = [0], [0]
    norm, residual = transformer.rmsnorm, transformer._residual

    def counted(fn):
        def wrapper(*args, **kw):
            oc = getattr(collectives.OBSERVER, "__self__", None)
            before = oc.bytes if oc is not None else 0
            out = fn(*args, **kw)
            if oc is not None:
                inside[0] += oc.bytes - before
                norms[0] += fn is norm
            return out
        return wrapper

    transformer.rmsnorm = counted(norm)
    transformer._residual = counted(residual)
    try:
        rec = dryrun.run_cell(*CELL, system="rns", seq_shard=seq_shard,
                              reduced=True, out_dir=str(tmp),
                              tag="sp" if seq_shard else "")
    finally:
        transformer.rmsnorm, transformer._residual = norm, residual
    return rec, inside[0], norms[0]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry_train")
    return {sp: _cell(tmp, sp) for sp in (False, True)}


def test_seq_shard_puts_norms_on_shards(cells):
    (base, b_in, b_calls), (sp, s_in, s_calls) = cells[False], cells[True]
    assert sp["seq_shard"] and not base["seq_shard"]
    assert b_calls == s_calls > 0
    scales = b_calls * get_config(CELL[0]).reduced().d_model * 4
    assert b_in - scales == 16 * (s_in - scales) > 0, (b_in, s_in)


def test_train_cell_counts_the_sharded_step(cells):
    """Rank 0's blocks and rows: FSDP gathers and reduce-scatters over the
    data axis, the plans' collectives over the model axis, every
    projection a B1 launch; the same kernels and FLOPs with and without
    SP, and SP's sequence gathers on top."""
    base, sp = cells[False][0], cells[True][0]
    assert base["count_s"] < 300 and sp["count_s"] < 300
    for rec in (base, sp):
        oc = rec["op_cost"]
        assert {"all-gather", "all-reduce", "reduce-scatter"} <= \
            set(oc["coll"])
        assert oc["launches"]["rns_matmul"] > 0
        assert rec["opt_bytes_dev"] > 0
    assert base["op_cost"]["launches"] == sp["op_cost"]["launches"]
    assert base["op_cost"]["ops"]["int8"] == sp["op_cost"]["ops"]["int8"]
    assert sp["op_cost"]["coll"]["all-gather"]["count"] > \
        base["op_cost"]["coll"]["all-gather"]["count"]


def test_cli_seq_shard_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         CELL[0], "--shape", CELL[1], "--system", "bns", "--reduced",
         "--seq-shard", "--out-dir", str(tmp_path), "--tag", "sp"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    name = f"{CELL[0]}_{CELL[1]}_single_bns_sp.json"
    with open(os.path.join(tmp_path, name)) as f:
        rec = json.load(f)
    assert rec["seq_shard"] is True and rec["reduced"] is True
    assert rec["op_cost"]["coll_bytes"] > 0
