"""The sharded train step under ``sdrns`` on (1, 2) against the reference's
single-device ``make_train_step``, with the limits and the bit-exact
logits of ``test_torch_mesh_train.py`` (whose cases these are; apart
because the reference's sdrns step takes most of a minute alone)."""
from __future__ import annotations

import torch

from test_torch_mesh_train import check_case, run_cases
from torch_threads import one_thread  # noqa: F401


def test_sdrns_tp_step(tmp_path):
    ranks, refs, one = run_cases(tmp_path, [("sdrns", "tp")])
    for r in range(2):
        got = ranks[r]["sdrns/tp"]
        check_case(got, refs["sdrns"])
        assert torch.equal(got["logits"], one["sdrns"]), r
