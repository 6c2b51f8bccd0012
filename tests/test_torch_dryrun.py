"""The port's dry run on the meta device (``launch/dryrun.py``) against the
reference's committed records, its CLI and the report it feeds.

Each reduced record of ``experiments/dryrun/`` is reproduced field for
field (``tests/torch_dryrun_records.py``); the full-width ones are in
``test_torch_dryrun_full.py`` and, for qwen3-8b decode_32k under rns,
here through the CLI.  The train cells' sharded step and ``--seq-shard`` are
``test_torch_dryrun_train.py``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from torch_dryrun_records import FIELDS, RECORD_DIR, check_cell, records
from torch_threads import one_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("name", records(reduced=True))
def test_reduced_record_fields(name, tmp_path):
    got = check_cell(name, str(tmp_path))
    oc = got["op_cost"]
    assert oc["ops"]["int8"] > 0 and oc["bytes"] > 0
    # every serving cell of the records runs its plan's collectives
    assert oc["coll_bytes"] > 0


def _cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_cli_writes_records_the_report_renders(tmp_path):
    out = str(tmp_path)
    for extra, name in (
            ([], "qwen3-8b_decode_32k_single_rns.json"),
            (["--mesh", "channel", "--channel-shard", "--tag", "cshard"],
             "qwen3-8b_decode_32k_channel_rns_cshard.json")):
        res = _cli("repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                   "--shape", "decode_32k", "--system", "rns",
                   "--out-dir", out, *extra)
        assert res.returncode == 0, res.stdout + res.stderr
        assert os.path.exists(os.path.join(out, name))
    with open(os.path.join(out, "qwen3-8b_decode_32k_single_rns.json")) as f:
        got = json.load(f)
    with open(os.path.join(RECORD_DIR,
                           "qwen3-8b_decode_32k_single_rns.json")) as f:
        ref = json.load(f)
    assert {k: got[k] for k in FIELDS} == {k: ref[k] for k in FIELDS}
    # B9 decodes each B1 launch's residues: one launch each
    assert got["op_cost"]["launches"] == {"rns_matmul": 253,
                                          "rns_decode": 253,
                                          "flash_decode": 36}
    with open(os.path.join(out, name)) as f:
        chan = json.load(f)
    assert chan["n_devices"] == 255 and chan["channel_shard"]
    # the channel plan's one partial-CRT all-reduce a matmul; B 128 does
    # not divide the data axis (85), so no rows are split or gathered
    assert set(chan["op_cost"]["coll"]) == {"all-reduce"}
    for mesh, tag in (("single", ""), ("channel", "cshard")):
        res = _cli("repro_torch.roofline.report", "--dir", out, "--mesh",
                   mesh, "--backend", "rns", "--tag", tag)
        assert res.returncode == 0, res.stdout + res.stderr
        rows = [ln for ln in res.stdout.splitlines()
                if ln.startswith("| qwen3-8b | decode_32k")]
        assert len(rows) == 1 and "fits 80G" in res.stdout, res.stdout

