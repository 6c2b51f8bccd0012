"""The port's dry run at full width against the reference's committed
qwen3-8b records (decode_32k under sdrns, prefill_32k under rns and sdrns;
decode_32k under rns runs in ``test_torch_dryrun.py`` through the CLI):
every framework-free field exactly, on the meta device."""
from __future__ import annotations

import pytest

from torch_dryrun_records import check_cell, records
from torch_threads import one_thread  # noqa: F401

FULL = [n for n in records(reduced=False)
        if n != "qwen3-8b_decode_32k_single_rns.json"]


@pytest.mark.parametrize("name", FULL)
def test_full_record_fields(name, tmp_path):
    got = check_cell(name, str(tmp_path))
    assert got["param_bytes_dev"] in (100033632, 632165472)
