"""``Model.loss``, its gradients and one AdamW step of the port against the
JAX package under rns: the moe (moonshot-v1-16b-a3b: the load-balance
loss, expert stacks on the per-call path), ssm (mamba2-780m) and hybrid
(zamba2-7b) families.

The check is ``torch_train_parity.check_family``; its docstring gives the
limits.  The families are spread over three files so that each runs in
under a minute.
"""
from __future__ import annotations

import pytest

from torch_threads import one_thread  # noqa: F401
from torch_train_parity import check_family


@pytest.mark.parametrize("arch,system", [
    ("moonshot-v1-16b-a3b", "rns"), ("mamba2-780m", "rns"),
    ("zamba2-7b", "rns")])
def test_loss_grads_and_adamw_step_match_reference(arch, system):
    check_family(arch, system)
