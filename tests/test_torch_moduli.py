"""Port parity: residue conversions, packed KV codec and quantizer.

The same seeded numpy inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (plain PyTorch on the CPU); integer results must match bit
for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moduli as jm
from repro.quant import quant as jq
from repro_torch.core import moduli as tm
from repro_torch.quant import quant as tq

from torch_threads import one_thread  # noqa: F401

SETS = [("P21", jm.P21, tm.P21), ("P16", jm.special_set(5), tm.special_set(5)),
        ("P24", jm.special_set(8), tm.special_set(8))]


def _int32_cases(mset_half_range: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = mset_half_range
    edge = np.array([0, 1, -1, 63, 64, -64, 65, -65, 127, 128, -128, 129,
                     h, -h, h - 1, -h + 1, 2**31 - 1, -2**31 + 1], np.int64)
    near = rng.integers(-h, h + 1, 4000)
    wide = rng.integers(-2**31 + 1, 2**31, 4000)
    # multiples of 128 plus 64: the even-modulus centering edge r == m/2
    half_edge = rng.integers(-2**20, 2**20, 500) * 128 + 64
    return np.concatenate([edge, near, wide, half_edge]).astype(np.int32)


@pytest.mark.parametrize("name,jset,tset", SETS, ids=[s[0] for s in SETS])
def test_to_residues_and_center_bit_exact(name, jset, tset):
    x = _int32_cases(jset.half_range, 0)
    j = np.asarray(jset.to_residues(jnp.asarray(x)))
    t = tset.to_residues(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t, j)
    jc = np.asarray(jset.to_residues(jnp.asarray(x), centered=False))
    tc = tset.to_residues(torch.from_numpy(x), centered=False).numpy()
    np.testing.assert_array_equal(tc, jc)
    # center() of arbitrary representatives (canonical and shifted by m)
    reps = jc + np.asarray(jset.moduli).reshape(-1, 1) * (
        np.arange(x.size) % 3 - 1)
    np.testing.assert_array_equal(
        tset.center(torch.from_numpy(reps.astype(np.int32))).numpy(),
        np.asarray(jset.center(jnp.asarray(reps.astype(np.int32)))))
    if 128 in jset.moduli:
        c = jset.moduli.index(128)
        assert (t[c][(x.astype(np.int64) % 128) == 64] == 64).all()


@pytest.mark.parametrize("name,jset,tset", SETS, ids=[s[0] for s in SETS])
def test_from_residues_bit_exact(name, jset, tset):
    rng = np.random.default_rng(1)
    h = jset.half_range
    x = np.concatenate([rng.integers(-h, h + 1, 5000),
                        [h, -h, 0, 1, -1]]).astype(np.int32)
    res = np.asarray(jset.to_residues(jnp.asarray(x)))
    j = np.asarray(jset.from_residues(jnp.asarray(res)))
    t = tset.from_residues(torch.tensor(res)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, x)
    # non-canonical representatives decode identically
    shifted = res + np.asarray(jset.moduli).reshape(-1, 1)
    np.testing.assert_array_equal(
        tset.from_residues(torch.from_numpy(shifted.astype(np.int32))).numpy(),
        np.asarray(jset.from_residues(jnp.asarray(shifted.astype(np.int32)))))


def test_to_residues_int32_min_is_exact():
    """At x = -2**31 the reference's special-modulus folds overflow in
    ``abs`` and return residue 8 for 127 and 129; the port gives the exact
    residue.  Checked against the reference's exact host conversion."""
    x = np.array([-2**31], np.int32)
    t = tm.P21.to_residues(torch.from_numpy(x)).numpy()
    exact = jm.P21.to_residues_host([-2**31]).astype(np.int32)
    np.testing.assert_array_equal(t, exact)


@pytest.mark.parametrize("name", ["KV8", "KV4"])
def test_packed_format_bit_exact(name):
    jset, tset = getattr(jm, name), getattr(tm, name)
    jf, tf = jset.packed(), tset.packed()
    assert (tf.moduli, tf.widths, tf.values_per_byte) == (
        jf.moduli, jf.widths, jf.values_per_byte)
    lo, hi = -jset.M // 2, jset.M // 2 - 1
    rng = np.random.default_rng(2)
    vals = np.concatenate([np.arange(lo, hi + 1),
                           rng.integers(lo, hi + 1, 4096 - (hi - lo + 1))])
    x = rng.permutation(vals).astype(np.int32).reshape(8, 512)
    jb = np.asarray(jf.encode(jnp.asarray(x)))
    tb = tf.encode(torch.from_numpy(x))
    assert tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), jb)
    # every byte value decodes like the reference (not only encoded ones)
    allb = np.arange(256, dtype=np.uint8).reshape(1, 256)
    np.testing.assert_array_equal(
        tf.decode(torch.from_numpy(allb)).numpy(),
        np.asarray(jf.decode(jnp.asarray(allb))))
    np.testing.assert_array_equal(tf.decode(tb).numpy(), x)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [None, -1, -2])
def test_quantize_symmetric_bit_exact(bits, axis):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.5, (24, 40)).astype(np.float32)
    qmax = (1 << (bits - 1)) - 1
    # rounding ties: rows whose amax makes scale exact and values land on
    # k + 0.5 steps (half to even must decide them like the reference)
    x[0] = np.linspace(-qmax, qmax, 40) / 2 + 0.25
    x[0, 0] = qmax
    x[1, :] = (np.arange(40) % (2 * qmax)) - qmax + 0.5
    x[1, 0] = float(qmax)       # amax == qmax: scale 1, exact .5 ties
    x[2, :] = 0.0
    jqv, js = jq.quantize_symmetric(jnp.asarray(x), bits, axis=axis)
    tqv, ts = tq.quantize_symmetric(torch.from_numpy(x), bits, axis=axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.qmax_for_bits(bits) == jq.qmax_for_bits(bits)
