"""Port parity: redundant residues -- moduli, matmul, scrub, rns8r pages and
the paged decode's syndrome output (kernel B4's plain version).

Seeded numpy inputs go to the JAX package and to the port.  Integers
(residues, decodes, page bytes, syndrome counts, repair ledgers) must match
bit for bit; the attention output within the reference's f32 tolerance
(``tests/test_flash_attn.py``: 2e-5).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moduli as jm
from repro.kernels.flash_attn import flash_paged_decode_pallas
from repro.numerics import api as jnx
from repro.numerics import kv_pages as jkv
from repro.numerics import runners as jrun
from repro_torch.core import moduli as tm
from repro_torch.kernels import flash_attn as tfa
from repro_torch.numerics import api as tnx
from repro_torch.numerics import attention as tattn
from repro_torch.numerics import kv_pages as tkv
from repro_torch.numerics import runners as trun
from repro_torch.numerics.tensor import ResidueTensor

from torch_threads import one_thread  # noqa: F401

TOL = 2e-5
SETS = ["P21R2", "KV8R2"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", SETS)
def test_redundant_set_constants(name):
    j, t = getattr(jm, name), getattr(tm, name)
    assert t.moduli == j.moduli and t.redundant == j.redundant
    assert (t.num_info, t.info_moduli, t.redundant_moduli) == \
        (j.num_info, j.info_moduli, j.redundant_moduli)
    assert (t.M, t.half_range) == (j.M, j.half_range)
    assert t.info.moduli == j.info.moduli and t.info.redundant == 0
    # same range as the information set: P21R2 segments like P21
    assert trun.segment_count(12288, 7, 7, t) == \
        jrun.segment_count(12288, 7, 7, j)


def test_make_range_condition():
    with pytest.raises(ValueError, match="too small"):
        tm.ModuliSet.make((127, 128, 129, 5, 11), redundant=2)
    with pytest.raises(ValueError, match="redundant"):
        tm.ModuliSet.make((15, 16), redundant=2)


def _corrupt(res, rng, channels, moduli):
    bad = res.copy()
    for c in channels:
        bad[c] = bad[c] + rng.integers(1, moduli[c], bad[c].shape)
    return bad


CORRUPTIONS = [(name, ch) for name in SETS
               for ch in [(), (0,), (1,), (2,), (3,), (4,), (0, 3), (1, 2),
                          (2, 3), (3, 4)]
               if max(ch, default=0) < getattr(jm, name).num_channels]


@pytest.mark.parametrize("name,channels", CORRUPTIONS)
def test_syndromes_and_corrected_decode_bit_exact(name, channels):
    """Every channel corrupted singly, double faults, and the ``±half_range``
    edges: syndromes, corrected_decode and correct match the reference."""
    j, t = getattr(jm, name), getattr(tm, name)
    rng = np.random.default_rng(len(channels) * 10 + sum(channels))
    h = j.half_range
    x = rng.integers(-h, h + 1, 4000).astype(np.int32)
    x[:4] = [h, -h, 0, -1]
    res = np.asarray(j.to_residues(jnp.asarray(x)))
    np.testing.assert_array_equal(t.to_residues(_t(x)).numpy(), res)
    bad = _corrupt(res, rng, channels, j.moduli)
    for fn in ("syndromes", "corrected_decode"):
        np.testing.assert_array_equal(
            getattr(t, fn)(_t(bad)).numpy(),
            np.asarray(getattr(j, fn)(jnp.asarray(bad))))
    for a, b in zip(t.correct(_t(bad)), j.correct(jnp.asarray(bad))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if len(channels) == 1:      # a single fault is always repaired
        np.testing.assert_array_equal(t.corrected_decode(_t(bad)).numpy(), x)


def test_rns_run_corrupted_plane_equals_clean():
    """A P21R2 weight with one corrupted plane channel gives the fault-free
    product (``corrected_decode`` per segment), as the reference does."""
    rng = np.random.default_rng(4)
    M, K, N = 5, 300, 40
    a = rng.integers(-7, 8, (M, K)).astype(np.int32)
    w = rng.integers(-7, 8, (K, N)).astype(np.int32)
    planes = trun.encode_rns_planes(_t(w), tm.P21R2)
    jplanes = np.asarray(jrun.encode_rns_planes(jnp.asarray(w), jm.P21R2))
    np.testing.assert_array_equal(planes.numpy(), jplanes)
    clean = trun.rns_run(_t(a), planes, mset=tm.P21R2, max_abs_a=7,
                         max_abs_b=7)
    np.testing.assert_array_equal(clean.numpy(), a @ w)
    for c in range(5):
        bad = planes.clone()
        bad[c, 3, 7] += 1
        bad[c, 100, 2] -= 2
        got = trun.rns_run(_t(a), bad, mset=tm.P21R2, max_abs_a=7,
                           max_abs_b=7)
        ref = jrun.rns_run(jnp.asarray(a), jnp.asarray(bad.numpy()),
                           mset=jm.P21R2, max_abs_a=7, max_abs_b=7,
                           backend="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), a @ w)
        raw = trun.rns_run(_t(a), bad, mset=tm.P21R2, max_abs_a=7,
                           max_abs_b=7, verify=False)
        jraw = jrun.rns_run(jnp.asarray(a), jnp.asarray(bad.numpy()),
                            mset=jm.P21R2, max_abs_a=7, max_abs_b=7,
                            backend="ref", verify=False)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
        # unchecked, an information-channel fault reaches the value
        assert (raw.numpy() != a @ w).any() == (c < 3)


def test_decode_check_and_scrub_bit_exact():
    rng = np.random.default_rng(6)
    w = rng.normal(0, 1, (64, 24)).astype(np.float32)
    tt = tnx.encode(_t(w), tnx.EncodeSpec(mset=tm.P21R2, qbits=4))
    jt = jnx.encode(jnp.asarray(w), jnx.EncodeSpec(layout="rns", mset=jm.P21R2, qbits=4))
    np.testing.assert_array_equal(tt.planes.numpy(), np.asarray(jt.planes))
    bad = tt.planes.clone()
    bad[0, 1, 2] += 5                     # an information channel
    bad[3, 7, 9] -= 1                     # a witness
    bad[1, 4, 4] += 1
    bad[2, 4, 4] += 1                     # a double fault
    tb = ResidueTensor(bad, tt.scale, tm.P21R2, "rns", 4, 7)
    jb = type(jt)(jnp.asarray(bad.numpy()), jt.scale, jm.P21R2, "rns", 4, 7)
    np.testing.assert_array_equal(tnx.decode(tb, check=True).numpy(),
                                  np.asarray(jnx.decode(jb, check=True)))
    t2, tdet, tcor = tnx.scrub(tb)
    j2, jdet, jcor = jnx.scrub(jb)
    assert (tdet, tcor) == (jdet, jcor) == (3, 2)
    np.testing.assert_array_equal(t2.planes.numpy(), np.asarray(j2.planes))
    pages = tkv.make_paged_kv(1, 2, 4, 1, 8, fmt="rns8r", device="cpu")
    with pytest.raises(ValueError, match="rns_pack"):
        tnx.decode(pages.k, check=True)


# ---------------------------------------------------------------------------
# rns8r pages
# ---------------------------------------------------------------------------


def test_rns8r_quantize_bytes_all_lanes():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jp, js = jkv.quantize_to_format(jnp.asarray(x), jkv.KV_FORMATS["rns8r"])
    tp, ts = tkv.quantize_to_format(_t(x), tkv.KV_FORMATS["rns8r"])
    assert tp.shape == tuple(jp.shape) == (3, 5, 3, 2, 16)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for name in ("rns8", "rns8r", "bf16"):
        assert tkv.bytes_per_token(name, 8, 128) == \
            jkv.bytes_per_token(name, 8, 128)


def _faulty_pool(seed, faults):
    """A (2 layer, 4 page, ps 2, Kv 2, hd 4) rns8r pool with XOR faults
    ``(layer, page, row, lane, kv_head, dim, mask)``; numpy planes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (2, 4, 2, 2, 4)).astype(np.float32)
    planes, scale = jkv.quantize_to_format(jnp.asarray(x),
                                           jkv.KV_FORMATS["rns8r"])
    bad = np.asarray(planes).copy()
    for la, pg, row, lane, kvh, d, bit in faults:
        bad[la, pg, row, lane, kvh, d] ^= bit
    return bad, np.asarray(scale)


FAULT_SETS = [
    [],
    [(0, 1, 0, 1, 0, 2, 0x01)],                            # witness
    [(1, 2, 1, 0, 1, 3, 0x10)],                            # packed byte
    [(0, 3, 1, 1, 0, 0, 0x04), (0, 3, 1, 2, 0, 0, 0x02)],  # double
    [(0, 0, 0, 2, 1, 1, 0x80), (1, 1, 1, 0, 0, 0, 0x01),
     (1, 3, 0, 1, 1, 2, 0x33), (1, 3, 0, 0, 1, 2, 0x40)],  # mixed pages
]


@pytest.mark.parametrize("faults", FAULT_SETS)
def test_verify_and_repair_pages_bit_exact(faults):
    bad, scale = _faulty_pool(1, faults)
    mset_j = jkv.KV_FORMATS["rns8r"].mset
    jres = jkv.ResidueTensor(jnp.asarray(bad), jnp.asarray(scale), mset_j,
                             "rns_pack", 7)
    tres = ResidueTensor(_t(bad.copy()), _t(scale), tm.KV8R2, "rns_pack", 7)
    layers, pages = [0, 1], [1, 3, 2]
    j2, jdet, jcor, junc = jkv.repair_pages(jres, layers, pages)
    t2, tdet, tcor, tunc = tkv.repair_pages(tres, layers, pages)
    for a, b in ((tdet, jdet), (tcor, jcor), (tunc, junc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t2.planes.numpy(), np.asarray(j2.planes))
    jv, jd, jc = jkv.verify_pages(jres)
    tv, td, tc = tkv.verify_pages(ResidueTensor(_t(bad.copy()), _t(scale),
                                                tm.KV8R2, "rns_pack", 7))
    assert (td, tc) == (jd, jc)
    np.testing.assert_array_equal(tv.planes.numpy(), np.asarray(jv.planes))


# ---------------------------------------------------------------------------
# Kernel B4's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _syn_case(g, seed=3):
    B, Kv, hd, ps, n_pmax = 3, 2, 16, 4, 3
    H = Kv * g
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pmax
    dense = rng.normal(0, 1, (2, P, ps, Kv, hd)).astype(np.float32)
    planes, scales = [], []
    for i in range(2):
        p, s = jkv.quantize_to_format(jnp.asarray(dense[i]),
                                      jkv.KV_FORMATS["rns8r"])
        planes.append(np.asarray(p).copy())
        scales.append(np.asarray(s))
    # K: a witness flip (valid), a packed-byte flip (valid), a flip past
    # kv_len, a flip on a page no table names (page 0); V: two valid flips
    planes[0][1, 1, 1, 0, 5] ^= 0x01
    planes[0][2, 2, 0, 1, 3] ^= 0x02
    planes[0][5, 3, 2, 0, 0] ^= 0x01
    planes[0][0, 0, 1, 0, 0] ^= 0x07
    planes[1][4, 0, 2, 1, 9] ^= 0x01
    planes[1][7, 2, 0, 0, 15] ^= 0x40
    tab = (1 + np.arange(B * n_pmax, dtype=np.int32)).reshape(B, n_pmax)
    kv_len = np.array([9, 6, 12], np.int32)
    q = rng.normal(0, 1, (B, H, hd)).astype(np.float32)
    return q, planes, scales, tab, kv_len, ps


@pytest.mark.parametrize("g", [1, 2, 4])
def test_syndrome_plain_matches_pallas(g):
    q, planes, scales, tab, kv_len, ps = _syn_case(g)
    red = tm.KV8R2.redundant_moduli
    jout = flash_paged_decode_pallas(
        jnp.asarray(q), jnp.asarray(planes[0][:, :, 0]),
        jnp.asarray(planes[1][:, :, 0]), jnp.asarray(tab),
        jnp.asarray(kv_len), page_size=ps, k_scale=jnp.asarray(scales[0]),
        v_scale=jnp.asarray(scales[1]), moduli=tm.KV8R2.info_moduli,
        k_witness=jnp.asarray(planes[0][:, :, 1:]),
        v_witness=jnp.asarray(planes[1][:, :, 1:]), red_moduli=red,
        interpret=True)
    kp, vp = _t(planes[0]), _t(planes[1])
    tout = tfa.paged_decode_ref(
        _t(q), kp.select(2, 0), vp.select(2, 0), _t(scales[0]),
        _t(scales[1]), _t(tab), _t(kv_len), ps, tm.KV8R2.packed(),
        kp.narrow(2, 1, 2), vp.narrow(2, 1, 2), red)
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    # slot 0 sees the valid K witness and byte flips, slots 1 and 2 one V
    # flip each; the past-kv_len and unnamed-page flips count nothing
    np.testing.assert_array_equal(tout[3].numpy().sum(axis=(1, 2)),
                                  [2, 1, 1])


@pytest.mark.parametrize("syndrome", [False, True])
def test_paged_decode_dispatch_rns8r_matches_reference(syndrome):
    from repro.numerics.attention import paged_decode as jpaged

    q, planes, scales, tab, kv_len, ps = _syn_case(2, seed=5)
    fmt = tm.KV8R2
    tlay = tkv.PagedKV(ResidueTensor(_t(planes[0]), _t(scales[0]), fmt,
                                     "rns_pack", 7),
                       ResidueTensor(_t(planes[1]), _t(scales[1]), fmt,
                                     "rns_pack", 7))
    jlay = jkv.PagedKV(*(jkv.ResidueTensor(jnp.asarray(p), jnp.asarray(s),
                                           jm.KV8R2, "rns_pack", 7)
                         for p, s in zip(planes, scales)))
    tres = tattn.paged_decode(_t(q), tlay, _t(tab), _t(kv_len),
                              page_size=ps, syndrome=syndrome)
    jres = jpaged(jnp.asarray(q), jlay, jnp.asarray(tab),
                  jnp.asarray(kv_len), page_size=ps, backend="interpret",
                  syndrome=syndrome)
    if syndrome:
        np.testing.assert_array_equal(tres[1].numpy(), np.asarray(jres[1]))
        tres, jres = tres[0], jres[0]
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=TOL,
                               atol=TOL)


def test_syndrome_requires_redundant_format():
    pool = tkv.make_paged_kv(1, 3, 4, 2, 8, fmt="rns8", device="cpu")
    with pytest.raises(ValueError, match="syndrome"):
        tattn.paged_decode(torch.zeros(1, 2, 8), tkv.layer_slice(pool, 0),
                           torch.ones(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32), page_size=4,
                           syndrome=True)
