"""``Model.loss``, its gradients and one AdamW step of the port against the
JAX package for the bf16 moe grok-1-314b under rns: the reference runs
eagerly (``jax.disable_jit()``), on a batch of the tie-free embedding
rows.

The check is ``torch_train_parity.check_family``; its docstring gives the
limits.  The families are spread over three files so that each runs in
under a minute.
"""
from __future__ import annotations

import pytest

from torch_train_parity import check_family, one_thread  # noqa: F401


@pytest.mark.parametrize("arch,system", [("grok-1-314b", "rns")])
def test_loss_grads_and_adamw_step_match_reference(arch, system):
    check_family(arch, system)
