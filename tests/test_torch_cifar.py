"""Port parity: the paper's DNN evaluation (``data/cifar.py``).

The synthetic CIFAR-10 set and the networks' op counts equal the
reference's; a narrow CNN (conv 8, pool, conv 32, pool, fc 32, fc 10 on two
32 x 32 images: the first fc's K is 2048, two int6 segments) carried
across by ``convert.cnn_from_jax_params`` is held against the reference
under ``bns`` (float, within 1e-5) and under ``rns`` and ``sdrns`` at 6
bits against the reference's Pallas kernels in interpret mode: every
layer's int6 activation codes and exact int32 accumulators bit for bit,
the logits within 1e-6 and the argmax equal.  The ``sdrns`` logits equal
the ``rns`` logits bit for bit, and the plain kernel calls of a forward
are the counts ``numerics.runners``' segment cuts give.  The whole
AlexNet is ``tests/test_torch_cifar_alexnet.py``'s; the shared forwards
are ``tests/torch_cifar_parity.py``'s.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnx
from repro.core import moduli as jm
from repro.data import cifar as jc
from repro.quant import quant as jquant
from repro_torch.convert import cnn_from_jax_params
from repro_torch.data import cifar as tc

from torch_cifar_parity import (BITS, KERNELS, NARROW, QMAX, _jax_tree,
                                expected_calls, port_forward, ref_forward)
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def narrow():
    jspec, tspec = jc.CnnSpec("narrow", NARROW), tc.CnnSpec("narrow", NARROW)
    params = jc.init_cnn(jax.random.PRNGKey(0), jspec)
    images, _ = jc.synthetic_cifar(2, split="test")
    return jspec, tspec, params, cnn_from_jax_params(_jax_tree(params),
                                                     "cpu"), images


@pytest.fixture(scope="module")
def narrow_port(narrow):
    """The port's narrow forwards under rns and sdrns, run once."""
    _, tspec, _, tparams, images = narrow
    mp = pytest.MonkeyPatch()
    try:
        return {s: port_forward(tparams, tspec, images, s, mp)
                for s in ("rns", "sdrns")}
    finally:
        mp.undo()


def test_synthetic_cifar_bit_exact():
    for n, seed, split in ((64, 0, "train"), (16, 3, "test"), (1, 0, "test")):
        ji, jl = jc.synthetic_cifar(n, seed=seed, split=split)
        ti, tl = tc.synthetic_cifar(n, seed=seed, split=split)
        assert ti.dtype == ji.dtype == np.float32 and tl.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_op_counts_and_shapes_equal():
    for jspec, tspec in ((jc.ALEXNET, tc.ALEXNET), (jc.VGG16, tc.VGG16),
                         (jc.CnnSpec("narrow", NARROW),
                          tc.CnnSpec("narrow", NARROW))):
        assert tspec == tc.CnnSpec(jspec.name, jspec.layers)
        assert tc.op_counts(tspec) == jc.op_counts(jspec)
        shapes = tc.dense_shapes(tspec, 1)
        assert sum(M * K * N for M, K, N in shapes) == \
            jc.op_counts(jspec)["muls"]
        gen = torch.Generator().manual_seed(0)
        tparams = tc.init_cnn(gen, tspec, device="cpu")
        jparams = jax.eval_shape(lambda: jc.init_cnn(jax.random.PRNGKey(0),
                                                     jspec))
        assert sorted(tparams) == sorted(jparams)
        for name in jparams:
            for leaf in ("w", "b"):
                assert tuple(tparams[name][leaf].shape) == \
                    jparams[name][leaf].shape
        assert [tuple(tparams[n]["w"].shape) for n in sorted(
            tparams, key=lambda s: int(s[1:]))] == [(K, N) for _, K, N in
                                                     shapes]
    assert tc.op_counts(tc.ALEXNET)["muls"] == 172_173_312
    assert tc.op_counts(tc.VGG16)["muls"] == 332_111_872


def test_im2col_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    for k, stride in ((3, 1), (3, 2), (1, 1), (5, 1)):
        np.testing.assert_array_equal(
            tc._im2col(torch.from_numpy(x), k, stride).numpy(),
            np.asarray(jc._im2col(jnp.asarray(x), k, stride)))


def test_narrow_cnn_bns_matches_reference(narrow, monkeypatch):
    jspec, tspec, params, tparams, images = narrow
    want, _ = ref_forward(params, jspec, images, "bns", None, monkeypatch)
    got, layers, calls = port_forward(tparams, tspec, images, "bns",
                                      monkeypatch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert layers == [] and calls == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("system", ["rns", "sdrns"])
def test_narrow_cnn_matches_reference_interpret(narrow, narrow_port, system,
                                                monkeypatch):
    jspec, tspec, params, _, images = narrow
    want, inputs = ref_forward(params, jspec, images, system, "interpret",
                               monkeypatch)
    got, layers, calls = narrow_port[system]
    names = sorted(params, key=lambda s: int(s[1:]))
    assert len(inputs) == len(layers) == len(names)
    assert [K for _, K, _ in tc.dense_shapes(tspec, 2)][2] == 2048
    layout = "sd" if system == "sdrns" else "rns"
    for name, x, (a, acc) in zip(names, inputs, layers):
        qx, _ = jquant.quantize_symmetric(jnp.asarray(x), BITS, axis=-1)
        np.testing.assert_array_equal(a.numpy(), np.asarray(qx), err_msg=name)
        qw, _ = jquant.quantize_symmetric(jnp.asarray(params[name]["w"]),
                                          BITS, axis=0)
        t = jnx.encode(qw, jnx.EncodeSpec(layout=layout, mset=jm.P21,
                                          qbits=BITS))
        ref_acc = jnx.matmul(qx, t, max_abs_a=QMAX, backend="interpret")
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc),
                                      err_msg=name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert calls == expected_calls(tspec, 2, system)


def test_sdrns_logits_equal_rns_bit_for_bit(narrow_port):
    rns, sdrns = narrow_port["rns"], narrow_port["sdrns"]
    np.testing.assert_array_equal(sdrns[0], rns[0])
    for (a_r, acc_r), (a_s, acc_s) in zip(rns[1], sdrns[1]):
        np.testing.assert_array_equal(a_s.numpy(), a_r.numpy())
        np.testing.assert_array_equal(acc_s.numpy(), acc_r.numpy())
    # the first fc (K 2048) takes two segments; its rows (M 2) the matvec
    assert rns[2]["rns_matmul"] == 5 and sdrns[2]["sdrns_matvec"] == 3
