"""The committed reference dry-run records (``experiments/dryrun/``) and
the fields of theirs that do not depend on XLA, which the port's dry run
(``repro_torch/launch/dryrun.py``) must reproduce exactly."""
from __future__ import annotations

import glob
import json
import os

RECORD_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments",
                          "dryrun")
FIELDS = ("n_devices", "params_total", "params_active", "model_flops_total",
          "param_bytes_dev", "cache_bytes_dev", "residue_resident")


def _reduced(path: str) -> bool:
    with open(path) as f:
        return json.load(f)["reduced"]


def records(reduced: bool) -> list[str]:
    return [os.path.basename(p) for p in sorted(glob.glob(
        os.path.join(RECORD_DIR, "*.json"))) if _reduced(p) == reduced]


def check_cell(name: str, out_dir: str) -> dict:
    """Run the record's cell in the port and hold its fields."""
    from repro_torch.launch.dryrun import run_cell

    with open(os.path.join(RECORD_DIR, name)) as f:
        ref = json.load(f)
    got = run_cell(ref["arch"], ref["shape"], ref["mesh"],
                   system=ref["system"], channel_shard=ref["channel_shard"],
                   reduced=ref["reduced"], out_dir=out_dir, tag=ref["tag"])
    assert {k: got[k] for k in FIELDS} == {k: ref[k] for k in FIELDS}, name
    assert os.path.exists(os.path.join(out_dir, name))
    return got
