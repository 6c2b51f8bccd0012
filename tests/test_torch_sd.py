"""Port parity: the signed-digit core (``core/sd.py``, ``core/sdrns.py``)
bit for bit against the JAX package.

The same seeded numpy digit vectors and integers go through ``repro``
(JAX, CPU) and ``repro_torch`` (PyTorch, CPU).  Every result is an integer
digit vector or value, so every comparison is exact: the digit vectors,
not only their values, must be the reference's.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moduli as jm
from repro.core import sd as jsd
from repro.core import sdrns as jsr
from repro_torch.core import moduli as tm
from repro_torch.core import sd as tsd
from repro_torch.core import sdrns as tsr

KINDS = ("pow2m1", "pow2", "pow2p1")


def _digits(rng, *shape):
    return rng.integers(-1, 2, shape).astype(np.int8)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _all_vectors(n):
    return np.array(list(itertools.product((-1, 0, 1), repeat=n)), np.int8)


def test_moduli_kinds_and_p16_match_reference():
    for jset, tset in ((jm.P16, tm.P16), (jm.P21, tm.P21),
                       (jm.P21R2, tm.P21R2), (jm.KV8, tm.KV8),
                       (jm.special_set(3), tm.special_set(3))):
        assert tset.kinds == jset.kinds
    assert tm.P16.moduli == jm.P16.moduli == (31, 32, 33)


def test_from_int_to_int_round_trip():
    rng = np.random.default_rng(0)
    x = rng.integers(-255, 256, 3000).astype(np.int32)
    x[:3] = (0, 255, -255)
    t = tsd.from_int(torch.from_numpy(x), 8)
    assert t.dtype == torch.int8
    _eq(t, jsd.from_int(jnp.asarray(x), 8))
    _eq(tsd.to_int(t), jsd.to_int(jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(tsd.to_int(t).numpy(), x)
    d = _digits(rng, 500, 9)                  # any digits, not just from_int
    _eq(tsd.to_int(torch.from_numpy(d)), jsd.to_int(jnp.asarray(d)))


@pytest.mark.parametrize("n", [1, 3, 5])
def test_carry_free_add_exhaustive(n):
    v = _all_vectors(n)
    x, y = np.repeat(v, len(v), 0), np.tile(v, (len(v), 1))
    t = tsd.carry_free_add(torch.from_numpy(x), torch.from_numpy(y))
    _eq(t, jsd.carry_free_add(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(
        tsd.to_int(t).numpy(),
        jsd.to_int(jnp.asarray(x)) + jsd.to_int(jnp.asarray(y)))
    _eq(tsd.negate(torch.from_numpy(x)), jsd.negate(jnp.asarray(x)))
    _eq(tsd.shift_left(torch.from_numpy(x), 2),
        jsd.shift_left(jnp.asarray(x), 2))


@pytest.mark.parametrize("count", [1, 2, 3, 5, 6, 7, 9])
def test_add_tree_and_pairwise_reduce_at_odd_counts(count):
    rng = np.random.default_rng(count)
    pps = _digits(rng, 40, count, 6)
    _eq(tsd.add_tree(torch.from_numpy(pps)), jsd.add_tree(jnp.asarray(pps)))
    for kind in KINDS:
        stack = _digits(rng, count, 30, 7)
        t = tsd.pairwise_reduce(torch.from_numpy(stack), 0,
                                lambda a, b: tsr.modular_add(a, b, kind))
        j = jsd.pairwise_reduce(jnp.asarray(stack), 0,
                                lambda a, b: jsr.modular_add(a, b, kind))
        _eq(t, j)


@pytest.mark.parametrize("n", [5, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_modular_add_and_rotations(n, kind):
    rng = np.random.default_rng(n)
    if n == 5:                                # every pair of 5-digit vectors
        v = _all_vectors(n)
        x, y = np.repeat(v, len(v), 0), np.tile(v, (len(v), 1))
    else:
        x, y = _digits(rng, 20000, n), _digits(rng, 20000, n)
    tx, ty, jx, jy = (torch.from_numpy(x), torch.from_numpy(y),
                      jnp.asarray(x), jnp.asarray(y))
    _eq(tsr.modular_add(tx, ty, kind), jsr.modular_add(jx, jy, kind))
    for a in range(2 * n):
        _eq(tsr.rotate_pp(tx, a, kind), jsr.rotate_pp(jx, a, kind))
    _eq(tsr.modular_mul(tx[:3000], ty[:3000], kind),
        jsr.modular_mul(jx[:3000], jy[:3000], kind))


def test_modular_mul_every_pair_of_p16_residues():
    """Every pair of centred residues of each P16 channel (31, 32, 33):
    digits equal the reference's and decode to the product mod m."""
    for c, ((kind, n), m) in enumerate(zip(tm.P16.kinds, tm.P16.moduli)):
        r = np.arange(-(m // 2) + (m % 2 == 0), m // 2 + 1, dtype=np.int32)
        a, b = np.repeat(r, len(r)), np.tile(r, len(r))
        ta = tsr.encode_residue(torch.from_numpy(a), n)
        tb = tsr.encode_residue(torch.from_numpy(b), n)
        t = tsr.modular_mul(ta, tb, kind)
        _eq(t, jsr.modular_mul(jsr.encode_residue(jnp.asarray(a), n),
                               jsr.encode_residue(jnp.asarray(b), n), kind))
        want = np.remainder(a.astype(np.int64) * b, m)
        want = np.where(want > m // 2, want - m, want)
        np.testing.assert_array_equal(
            tsr.decode_residue(t, kind, n).numpy(), want)


def test_sdrns_number_end_to_end_on_p21():
    rng = np.random.default_rng(7)
    x = rng.integers(-1000, 1000, 500).astype(np.int32)
    y = rng.integers(-1000, 1000, 500).astype(np.int32)
    tx = tsr.SdRnsNumber.from_int(torch.from_numpy(x), tm.P21)
    ty = tsr.SdRnsNumber.from_int(torch.from_numpy(y), tm.P21)
    jx = jsr.SdRnsNumber.from_int(jnp.asarray(x), jm.P21)
    jy = jsr.SdRnsNumber.from_int(jnp.asarray(y), jm.P21)
    for t, j, want in ((tx, jx, x), (tx + ty, jx + jy, x + y),
                       (tx * ty, jx * jy, x * y), (-tx, -jx, -x)):
        _eq(t.digits, j.digits)
        _eq(t.to_int(), j.to_int())
        np.testing.assert_array_equal(t.to_int().numpy(), want)
    with pytest.raises(ValueError, match="SD-RNS"):
        tsr.SdRnsNumber(tx.digits, tm.ModuliSet.make((127, 129, 131)))
