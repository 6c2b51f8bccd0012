"""``Model.loss``, its gradients and one AdamW step of the port against the
JAX package: the dense (qwen3-8b under rns and bns), vlm (pixtral-12b)
and audio (whisper-small, the teacher-forced encoder-decoder loss)
families under rns, and the bf16 moe grok-1-314b under bns.

The check is ``torch_train_parity.check_family``; its docstring gives the
limits.  The families are spread over three files so that each runs in
under a minute.
"""
from __future__ import annotations

import pytest

from torch_train_parity import check_family, one_thread  # noqa: F401


@pytest.mark.parametrize("arch,system", [
    ("qwen3-8b", "rns"), ("qwen3-8b", "bns"), ("pixtral-12b", "rns"),
    ("whisper-small", "rns"), ("grok-1-314b", "bns")])
def test_loss_grads_and_adamw_step_match_reference(arch, system):
    check_family(arch, system)
