"""Port parity: the whole CIFAR-scale AlexNet (``data/cifar.py``) at batch
1 under ``bns`` (within 1e-5) and ``rns`` (int6 codes on P21, within 1e-6,
argmax equal) against the reference's ``impl="ref"``, with the plain
kernel calls of the ``rns`` forward (17) the runners' segment cuts.  The
narrow CNN's layer-by-layer parity is ``tests/test_torch_cifar.py``'s.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.data import cifar as jc
from repro_torch.convert import cnn_from_jax_params
from repro_torch.data import cifar as tc

from torch_cifar_parity import (_jax_tree, expected_calls, port_forward,
                                ref_forward)
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def alexnet():
    params = jc.init_cnn(jax.random.PRNGKey(1), jc.ALEXNET)
    return params, cnn_from_jax_params(_jax_tree(params), "cpu")


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_alexnet_batch1_matches_reference(alexnet, system, monkeypatch):
    params, tparams = alexnet
    images, _ = jc.synthetic_cifar(1, split="test")
    want, _ = ref_forward(params, jc.ALEXNET, images, system, "ref",
                          monkeypatch)
    got, _, calls = port_forward(tparams, tc.ALEXNET, images, system,
                                 monkeypatch)
    assert np.isfinite(got).all() and got.shape == (1, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if system == "bns" else 1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if system == "rns":
        assert calls == expected_calls(tc.ALEXNET, 1, "rns")
        assert calls["rns_matmul"] == 17
