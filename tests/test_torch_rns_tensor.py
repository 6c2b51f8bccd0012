"""Port parity: the wide moduli sets (P24, P33, P64), the special-modulus
folds, the exact host codecs, the channel-wise ring ops, ``RnsTensor`` and
``ResidueTensor.flush``.

The same seeded numpy inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (plain PyTorch on the CPU); integer results match bit for
bit and are held against Python's integers where the reference is not
exact (P24's int8 planes, below).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnx
from repro.core import moduli as jm
from repro.core.rns import RnsTensor as JRnsTensor
from repro_torch.core import moduli as tm
from repro_torch.core.rns import RnsTensor
from repro_torch.numerics import api as tnx
from repro_torch.numerics.tensor import ResidueTensor

from torch_threads import one_thread  # noqa: F401

WIDE = ["P24", "P33", "P64"]
INT32_EDGES = np.array([0, 1, -1, 127, 128, -128, 129, 2**31 - 1, -2**31,
                        -2**31 + 1], np.int64)


def _sets(name):
    return getattr(jm, name), getattr(tm, name)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", WIDE + ["P16", "P21", "P21R2"])
def test_set_structure_matches_reference(name):
    j, t = _sets(name)
    assert t.moduli == j.moduli and t.redundant == j.redundant
    assert t.kinds == j.kinds
    assert (t.M, t.M_total, t.half_range, t.precision_bits) == \
        (j.M, j.M_total, j.half_range, j.precision_bits)
    assert t.lazy_add_capacity() == j.lazy_add_capacity()
    n = {"P24": 8, "P33": 11, "P64": 21}.get(name)
    if n is not None:          # Table I's rows: {2^n - 1, 2^n, 2^n + 1}
        assert t == tm.special_set(n) and t.precision_bits == 3 * n


def test_with_redundancy_gives_p21r2():
    assert jm.P21.with_redundancy((131, 133)) == jm.P21R2
    t = tm.P21.with_redundancy((131, 133))
    assert t == tm.P21R2 and t.redundant == 2 and t.M == tm.P21.M
    assert t.M_total == tm.P21.M * 131 * 133
    with pytest.raises(ValueError):
        tm.P21.with_redundancy((131,)).with_redundancy((2,))


@pytest.mark.parametrize("n", [5, 7, 8, 11, 21])
def test_special_folds_bit_exact(n):
    rng = np.random.default_rng(n)
    x = np.concatenate([INT32_EDGES, rng.integers(-2**31, 2**31, 20000),
                        rng.integers(-4096, 4096, 2000)]).astype(np.int32)
    for fn in ("mod_pow2", "mod_pow2_minus1", "mod_pow2_plus1"):
        want = np.asarray(getattr(jm, fn)(jnp.asarray(x), n))
        got = getattr(tm, fn)(_t(x), n).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn)
    assert tm._folds_needed(31, n) == jm._folds_needed(31, n)
    # away from -2**31 (whose abs wraps in both) the folds are the residues
    ok = x != np.int32(-2**31)
    for fn, m in (("mod_pow2", 1 << n), ("mod_pow2_minus1", (1 << n) - 1),
                  ("mod_pow2_plus1", (1 << n) + 1)):
        np.testing.assert_array_equal(
            getattr(tm, fn)(_t(x), n).numpy()[ok],
            (x[ok].astype(np.int64) % m))


@pytest.mark.parametrize("name", WIDE)
def test_device_round_trips_match_reference(name):
    j, t = _sets(name)
    rng = np.random.default_rng(3)
    h = min(j.half_range, 2**31 - 1)
    x = np.concatenate([INT32_EDGES[INT32_EDGES != -2**31],
                        rng.integers(-h, h + 1, 5000),
                        rng.integers(-2**31 + 1, 2**31, 2000)]
                       ).astype(np.int32)
    res_j = np.asarray(j.to_residues(jnp.asarray(x)))
    res_t = t.to_residues(_t(x))
    np.testing.assert_array_equal(res_t.numpy(), res_j)
    if name == "P64":
        # both refuse the device decode above 46340 (the host path decodes)
        with pytest.raises(ValueError):
            j.from_residues(jnp.asarray(res_j))
        with pytest.raises(ValueError):
            t.from_residues(res_t)
        return
    back = t.from_residues(res_t).numpy()
    want = np.asarray(j.from_residues(jnp.asarray(res_j)))
    np.testing.assert_array_equal(back, want)
    inside = np.abs(x.astype(np.int64)) <= j.half_range
    np.testing.assert_array_equal(back[inside], x[inside])
    if name == "P33":
        # M > 2**32: a value past int32 wraps modulo 2**32 in both packages
        big = np.array([2**31 + 5, -(2**32) - 7, j.half_range], np.int64)
        r = j.to_residues_host(big)
        np.testing.assert_array_equal(
            t.from_residues(_t(r).to(torch.int32)).numpy(),
            np.asarray(j.from_residues(jnp.asarray(r, jnp.int32))))


@pytest.mark.parametrize("name", WIDE + ["P21R2"])
def test_host_codecs_exact_at_any_width(name):
    j, t = _sets(name)
    rng = np.random.default_rng(4)
    h = j.half_range
    vals = [0, 1, -1, h, -h, h - 1, -h + 1, 2**31, -2**31 - 1] + [
        int(v) % (2 * h + 1) - h
        for v in rng.integers(0, 2**62, 200, dtype=np.int64)]
    vals = [v for v in vals if abs(v) <= h]
    xs = np.array(vals, dtype=object)
    r_t, r_j = t.to_residues_host(xs), j.to_residues_host(xs)
    assert r_t.dtype == np.int64
    np.testing.assert_array_equal(r_t, r_j)
    for c, m in enumerate(t.moduli):          # centered residues
        assert all(-(m // 2) <= int(v) <= m // 2 for v in r_t[c])
        assert all((int(v) - x) % m == 0 for v, x in zip(r_t[c], vals))
    back = t.from_residues_host(r_t)
    assert list(back) == vals == list(j.from_residues_host(r_j))


@pytest.mark.parametrize("name", ["P24", "P33", "P21"])
def test_ring_ops_against_int_oracle(name):
    j, t = _sets(name)
    rng = np.random.default_rng(5)
    h = int(np.sqrt(j.half_range)) // 2
    a = rng.integers(-h, h + 1, (6, 50)).astype(np.int32)
    b = rng.integers(-h, h + 1, (6, 50)).astype(np.int32)
    ra, rb = t.to_residues(_t(a)), t.to_residues(_t(b))
    ja, jb = j.to_residues(jnp.asarray(a)), j.to_residues(jnp.asarray(b))
    for op, want in (("add", a.astype(np.int64) + b),
                     ("sub", a.astype(np.int64) - b),
                     ("mul", a.astype(np.int64) * b)):
        got = getattr(t, op)(ra, rb)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(j, op)(ja, jb)))
        np.testing.assert_array_equal(t.from_residues(got).numpy(), want)
    lazy = ra * 3 + rb * 5 + 7 * torch.tensor(t.moduli).view(-1, 1, 1)
    np.testing.assert_array_equal(t.channel_mod(lazy).numpy(),
                                  np.asarray(j.channel_mod(jnp.asarray(
                                      lazy.numpy()))))
    np.testing.assert_array_equal(
        t.from_residues(t.channel_mod(lazy)).numpy(),
        3 * a.astype(np.int64) + 5 * b)


def test_p24_exact_where_the_257_residue_is_plus_128():
    """A centered residue mod 257 reaches +128, which int8 planes wrap to
    -128 (255 away): the reference stores P24's planes as int8 and is off
    by -255 * 256 * 128 there; the port stores them wider and is exact."""
    j, t = _sets("P24")
    c = t.moduli.index(257)
    base = np.array([128, 128 + 257 * 3, -129, 128 - 257 * 1000,
                     128 + 257 * 30000, 5, -128, 127], np.int64)
    base = base[np.abs(base) <= t.half_range].astype(np.int32)
    res = t.to_residues(_t(base)).numpy()
    plus = res[c] == 128
    assert plus.sum() >= 4
    w = base.reshape(1, -1)
    spec = tnx.EncodeSpec(layout="rns", mset=t)
    enc = tnx.encode(_t(w), spec)
    assert enc.planes.dtype != torch.int8
    np.testing.assert_array_equal(tnx.decode(enc).numpy(), w)
    ref = np.asarray(jnx.decode(jnx.encode(jnp.asarray(w), jnx.EncodeSpec(
        layout="rns", mset=j))))
    diff = ref.astype(np.int64) - w
    # off by -255 * 256 * 128 = -8 355 840, modulo M (it stays centered)
    np.testing.assert_array_equal(diff[0][plus] % t.M,
                                  (-255 * 256 * 128) % t.M)
    np.testing.assert_array_equal(diff[0][~plus], 0)
    assert ref[0][0] == 128 - 8_355_840 == -8_355_712
    # nx.add on typed tensors: sums whose 257 residue lands on +128
    rng = np.random.default_rng(6)
    x = rng.integers(-2**20, 2**20, (4, 64)).astype(np.int64)
    y = (128 - x) % 257 + 257 * rng.integers(-2**12, 2**12, (4, 64))
    y = y.astype(np.int32)
    tx = tnx.encode(_t(x.astype(np.int32)), spec)
    ty = tnx.encode(_t(y), spec)
    s = tnx.decode(tnx.add(tx, ty)).numpy()
    np.testing.assert_array_equal(s, x + y)
    assert (t.to_residues(_t(s.astype(np.int32)))[c] == 128).all()
    # the set's own ring ops (int32 in and out) are exact in both packages
    ra, rb = t.to_residues(_t(x.astype(np.int32))), t.to_residues(_t(y))
    for op, want in (("add", x + y), ("sub", x - y)):
        got = getattr(t, op)(ra, rb)
        np.testing.assert_array_equal(t.from_residues(got).numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, op)(
            jnp.asarray(ra.numpy()), jnp.asarray(rb.numpy()))))
    # products congruent to 128 mod 257: (1 + 257 j) * (128 + 257 k)
    f = rng.choice([1, 258, -256], (4, 64))
    g = 128 + 257 * rng.integers(-120, 121, (4, 64))
    r = t.mul(t.to_residues(_t(f.astype(np.int32))),
              t.to_residues(_t(g.astype(np.int32))))
    assert (r[c] == 128).all()
    np.testing.assert_array_equal(t.from_residues(r).numpy(), f * g)


def test_int8_planes_only_up_to_modulus_256():
    from repro_torch.numerics.runners import _res_dtype
    assert {s: _res_dtype(getattr(tm, s)) for s in (
        "P16", "P21", "P21R2", "KV8", "KV4", "P24", "P33", "P64")} == {
        "P16": torch.int8, "P21": torch.int8, "P21R2": torch.int8,
        "KV8": torch.int8, "KV4": torch.int8, "P24": torch.int32,
        "P33": torch.int32, "P64": torch.int32}


# ---------------------------------------------------------------------------
# RnsTensor: the reference's tests/test_rns_tensor.py cases, both packages
# ---------------------------------------------------------------------------


def _both(x: np.ndarray, name: str = "P21"):
    j, t = _sets(name)
    return (JRnsTensor.from_int(jnp.asarray(x, jnp.int32), j),
            RnsTensor.from_int(_t(x.astype(np.int32)), t))


@pytest.mark.parametrize("name", ["P21", "P24", "P33"])
def test_rns_tensor_ring_ops(name):
    rng = np.random.default_rng(0)
    a = rng.integers(-900, 900, size=(4, 8))
    b = rng.integers(-900, 900, size=(4, 8))
    ja, ta = _both(a, name)
    jb, tb = _both(b, name)
    np.testing.assert_array_equal(ta.residues.numpy(), np.asarray(ja.residues))
    for got, ref, want in (((ta + tb), (ja + jb), a + b),
                           ((ta - tb), (ja - jb), a - b),
                           ((ta * tb), (ja * jb), a * b),
                           ((-ta), (-ja), -a),
                           (ta.scale_by(3), ja.scale_by(3), 3 * a),
                           (ta.scale_by(-1000), ja.scale_by(-1000),
                            -1000 * a)):
        assert isinstance(got, RnsTensor)
        np.testing.assert_array_equal(got.residues.numpy(),
                                      np.asarray(ref.residues))
        np.testing.assert_array_equal(got.to_int().numpy(), want)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_rns_tensor_matmul_exact(batch):
    rng = np.random.default_rng(1)
    a = rng.integers(-7, 8, size=(*batch, 16, 64))
    b = rng.integers(-7, 8, size=(*batch, 64, 24))
    ja, ta = _both(a)
    jb, tb = _both(b)
    out = ta.matmul(tb)
    assert isinstance(out, RnsTensor) and out.residues.dtype == torch.int32
    np.testing.assert_array_equal(out.residues.numpy(),
                                  np.asarray(ja.matmul(jb).residues))
    np.testing.assert_array_equal(out.to_int().numpy(), a @ b)


def test_rns_tensor_matmul_lazy_operands_and_p33():
    """Non-canonical (lazily added) planes multiply exactly while K stays
    within the budget; P33 (capacity 1024) at K 1024."""
    rng = np.random.default_rng(2)
    a = rng.integers(-7, 8, size=(8, 32))
    b = rng.integers(-7, 8, size=(32, 8))
    ja, ta = _both(a)
    jb, tb = _both(b)
    got = ta.lazy_add(ta).matmul(tb.lazy_mul(tb))
    ref = ja.lazy_add(ja).matmul(jb.lazy_mul(jb))
    np.testing.assert_array_equal(got.residues.numpy(),
                                  np.asarray(ref.residues))
    np.testing.assert_array_equal(got.to_int().numpy(), (2 * a) @ (b * b))
    assert tm.P33.lazy_add_capacity() == 1024
    a = rng.integers(-1000, 1001, size=(4, 1024))
    b = rng.integers(-1000, 1001, size=(1024, 3))
    ja, ta = _both(a, "P33")
    jb, tb = _both(b, "P33")
    got = ta.matmul(tb)
    np.testing.assert_array_equal(got.residues.numpy(),
                                  np.asarray(ja.matmul(jb).residues))
    np.testing.assert_array_equal(got.to_int().numpy(), a @ b)


def test_rns_tensor_lazy_headroom_and_flush():
    ja, ta = _both(np.array(500))
    jacc, acc = ja, ta
    for _ in range(50):
        jacc, acc = jacc.lazy_add(ja), acc.lazy_add(ta)
    np.testing.assert_array_equal(acc.residues.numpy(),
                                  np.asarray(jacc.residues))
    assert int(acc.residues.abs().max()) > max(tm.P21.moduli) // 2
    flushed = acc.flush()
    assert isinstance(flushed, RnsTensor)
    assert int(flushed.to_int()) == 500 * 51 == int(jacc.flush().to_int())
    np.testing.assert_array_equal(flushed.residues.numpy(),
                                  np.asarray(jacc.flush().residues))


def test_rns_tensor_matmul_capacity_guard():
    big_k = tm.P21.lazy_add_capacity() + 1
    ta = RnsTensor(torch.zeros((3, 2, big_k), dtype=torch.int32), tm.P21)
    tb = RnsTensor(torch.zeros((3, big_k, 2), dtype=torch.int32), tm.P21)
    with pytest.raises(ValueError, match="lazy capacity"):
        ta.matmul(tb)
    with pytest.raises(ValueError, match="channels"):
        RnsTensor(torch.zeros((2, 4), dtype=torch.int32), tm.P21)
    with pytest.raises(ValueError, match="moduli mismatch"):
        RnsTensor(torch.zeros((3, 2, 2), dtype=torch.int32), tm.P21).matmul(
            RnsTensor(torch.zeros((3, 2, 2), dtype=torch.int32), tm.P24))
    with pytest.raises(ValueError):     # P64's capacity is 0
        _both(np.ones((2, 1)), "P64")[1].matmul(_both(np.ones((1, 2)),
                                                      "P64")[1])


def test_rns_tensor_is_a_residue_tensor():
    _, t = _both(np.arange(-4, 4))
    assert isinstance(t, ResidueTensor)
    assert t.layout == "rns" and t.channel_axis == 0 and t.shape == (8,)
    assert t.scale is None
    for out in (t + t, -t, t.flush(), t * t, t - t):
        assert isinstance(out, RnsTensor)
    np.testing.assert_array_equal(tnx.decode(t).numpy(), np.arange(-4, 4))


def test_residue_tensor_flush_matches_reference():
    """flush() re-centers rns planes in their storage dtype and leaves sd
    tensors as they are, as the reference's does."""
    rng = np.random.default_rng(7)
    w = rng.integers(-7, 8, (2, 16, 8)).astype(np.int32)
    jt = jnx.encode(jnp.asarray(w), jnx.EncodeSpec(layout="rns", mset=jm.P21,
                                                   qbits=4))
    tt = tnx.encode(_t(w), tnx.EncodeSpec(layout="rns", mset=tm.P21, qbits=4))
    assert tt.flush().planes.dtype == torch.int8
    np.testing.assert_array_equal(tt.flush().planes.numpy(),
                                  tt.planes.numpy())
    shift = (rng.integers(-3, 4, tt.planes.shape) * np.asarray(
        tm.P21.moduli).reshape(3, 1, 1)).astype(np.int32)
    lazy_t = tt._with_planes(tt.planes.to(torch.int32) + _t(shift))
    lazy_j = jt._with_planes(jt.planes.astype(jnp.int32) + jnp.asarray(shift))
    f_t, f_j = lazy_t.flush(), lazy_j.flush()
    assert f_t.planes.dtype == torch.int32
    np.testing.assert_array_equal(f_t.planes.numpy(), np.asarray(f_j.planes))
    np.testing.assert_array_equal(f_t.planes.numpy(), tt.planes.numpy())
    assert (f_t.qbits, f_t.max_abs, f_t.layout) == (4, 7, "rns")
    sd = tnx.encode(_t(w[0]), tnx.EncodeSpec(layout="sd", mset=tm.P21,
                                             qbits=4))
    assert sd.flush() is sd
