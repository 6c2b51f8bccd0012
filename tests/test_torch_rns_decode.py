"""Kernel B9, the reverse conversion after B1 (``kernels/rns_decode.py``,
``csrc/rns_decode.cu``), on the CPU.

* A host emulation of the kernel's per-element steps (the same constant
  tables, from the wrapper, and the same uint32 operations as the ``.cu``)
  equals ``ModuliSet.from_residues`` bit for bit on every set the kernel
  takes, the wrapping ones (P33, CRT40, a set at the 46340 limit)
  included, on random and edge representatives.
* The plain version adds into ``out`` in place, reads a stack and a set's
  leading channels through views, and the meta version gives the shapes.
* The wrapper refuses what the kernel does not take.
* ``runners._rns_local`` on the CPU decodes through the plain version and
  counts ``numerics.decode_eager``; a checked redundant set stays on
  ``corrected_decode``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import moduli as mm
from repro_torch.kernels import rns_decode as rd
from repro_torch.numerics import registry, runners
from repro_torch.roofline import op_cost

from torch_threads import one_thread  # noqa: F401

WIDE = mm.ModuliSet.make((46337, 46339, 46340))
SETS = {"P16": mm.P16, "P21": mm.P21, "P24": mm.P24, "P33": mm.P33,
        "CRT40": mm.CRT40, "KV8": mm.KV8, "KV4": mm.KV4,
        "P21R2.info": mm.P21R2.info, "WIDE": WIDE}
U32 = np.uint32


# ---- the kernel's per-element steps, on numpy uint32 ----------------------

def _reduce(x, m, magic):
    """``reduce``: x - umulhi(x, magic) * m, one conditional subtract."""
    q = ((x.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)
         ).astype(U32)
    r = x - q * U32(m)
    return np.where(r >= m, r - U32(m), r).astype(U32)


def _canon(x, m, magic, off):
    """``canon``: one compare for [-m, m), else (x + 2^31) mod m less
    2^31 mod m."""
    u = x.astype(np.int32).view(U32)
    r = np.where(u < m, u, u + U32(m))
    s = _reduce(u ^ U32(0x80000000), m, magic)
    s = np.where(s >= off, s - U32(off), s + U32(m) - U32(off))
    return np.where(r >= m, s, r).astype(U32)


def emulate(res: np.ndarray, mset: mm.ModuliSet) -> np.ndarray:
    """``decode<C>`` over the leading axis of int32 ``res``."""
    t = rd.decode_tables(mset.moduli)
    C = mset.num_channels
    d = [_canon(res[j], t.m[j], t.magic[j], t.off[j])
         for j in range(C)]
    for i in range(C):
        for j in range(i + 1, C):
            d[j] = _reduce(d[j] * U32(t.inv[i][j])
                           + d[i] * U32(t.ninv[i][j]),
                           t.m[j], t.magic[j])
    gt = np.zeros(d[0].shape, bool)
    eq = np.ones(d[0].shape, bool)
    for j in range(C - 1, -1, -1):
        gt = gt | (eq & (d[j] > t.half[j]))
        eq = eq & (d[j] == t.half[j])
    v = np.zeros(d[0].shape, U32)
    for j in range(C):
        v = v + d[j] * U32(t.prod[j])
    return np.where(gt, v - U32(t.big_m), v).astype(U32).view(np.int32)


def _representatives(mset: mm.ModuliSet, rng) -> np.ndarray:
    """(C, n) int32 residues: random int32 representatives; centred and
    canonical residues of random values in range; +-half_range, 0, +-1 and
    values past int32 (P33, CRT40, WIDE wrap there); those values' residues
    shifted by random multiples of each modulus within int32."""
    C, h = mset.num_channels, mset.half_range
    vals = [0, 1, -1, h, -h, h - 1, -h + 1, 2**31 - 1, -2**31,
            2**31, -2**31 - 1]
    vals = [v for v in vals if -h <= v <= h]
    vals += [int(v) for v in rng.integers(-h, h + 1, 2000)]
    if h > 2**31:
        vals += [int(v) for v in rng.integers(2**31, h + 1, 500)]
    cen = mset.to_residues_host(np.array(vals, dtype=object))
    can = np.stack([cen[c] % m for c, m in enumerate(mset.moduli)])
    shifted = np.stack([
        cen[c] + m * rng.integers(-((2**31 - m) // m), (2**31 - m) // m,
                                  cen.shape[1])
        for c, m in enumerate(mset.moduli)])
    edge = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 1], np.int64)
    grid = np.stack(np.meshgrid(*[edge] * min(C, 3), indexing="ij")
                    ).reshape(min(C, 3), -1)
    grid = np.concatenate([grid, np.zeros((C - grid.shape[0], grid.shape[1]),
                                          np.int64)])
    rand = rng.integers(-2**31, 2**31, (C, 4000))
    return np.concatenate([cen, can, shifted, grid, rand], axis=1
                          ).astype(np.int32)


@pytest.mark.parametrize("name", sorted(SETS))
def test_emulation_equals_from_residues(name):
    mset = SETS[name]
    assert rd.supports(mset)
    res = _representatives(mset, np.random.default_rng(len(name)))
    want = mset.from_residues(torch.from_numpy(res)).numpy()
    np.testing.assert_array_equal(emulate(res, mset), want)


@pytest.mark.parametrize("name", sorted(SETS))
def test_tables(name):
    mset = SETS[name]
    t = rd.decode_tables(mset.moduli)
    ms = mset.moduli
    for i, mi in enumerate(ms):
        assert t.magic[i] == 2**32 // mi and t.off[i] == 2**31 % mi
        for j in range(i + 1, len(ms)):
            assert mi * t.inv[i][j] % ms[j] == 1
            assert (t.inv[i][j] + t.ninv[i][j]) % ms[j] == 0
            # the MRC step's sum stays below 2^32
            assert (ms[j] - 1) * (ms[j] - 1 + mi - 1) < 2**32
    assert t.big_m == mset.M % 2**32
    assert len(rd._table_words(ms)) == 5 * 8 + 2 * 64 + 1  # Tables


# ---- the plain and meta versions, the wrapper's checks ----------------------

def _res(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, shape).astype(np.int32))


def test_ref_adds_in_place_and_reads_views():
    mset = mm.P21R2
    res = _res((4, 5, 3, 7))                     # (S, C', M, N), witnesses on
    want = mset.from_residues(res.movedim(1, 0))
    got = rd.rns_decode_ref(res, mset.info)
    assert torch.equal(got, want) and got.shape == (4, 3, 7)
    out = _res((4, 3, 7), 1)
    total = out.clone()
    assert rd.rns_decode_ref(res, mset.info, out) is out
    assert torch.equal(out, total + want)        # int32, wrapping
    one = rd.rns_decode_ref(res[2], mset.info)
    assert torch.equal(one, want[2])


def test_meta_shapes():
    for shape, out_shape in (((3, 5, 7), (5, 7)), ((4, 3, 5, 7), (4, 5, 7))):
        res = torch.empty(shape, dtype=torch.int32, device="meta")
        got = rd.rns_decode_meta(res, mm.P21)
        assert got.is_meta and got.shape == out_shape
        assert got.dtype == torch.int32
        out = torch.empty(out_shape, dtype=torch.int32, device="meta")
        assert rd.rns_decode_meta(res, mm.P21, out) is out
    impls = registry._REGISTRY["rns_decode"]
    assert registry.get_impl("rns_decode", "cpu") is impls["ref"]
    assert registry.get_impl("rns_decode", "meta") is impls["meta"]


def test_wrapper_refuses():
    res = _res((3, 4, 8))
    for fn in (rd.rns_decode_ref, rd.rns_decode_meta, rd.rns_decode_cuda):
        with pytest.raises(TypeError):
            fn(res.long(), mm.P21)
        with pytest.raises(ValueError):
            fn(res[0], mm.P21)                       # no channel axis
        with pytest.raises(ValueError):
            fn(res[:2], mm.P21)                      # too few channels
        with pytest.raises(ValueError):
            fn(res, mm.P21, torch.zeros(4, 8, dtype=torch.int64))
        with pytest.raises(ValueError):
            fn(res, mm.P21, torch.zeros(8, 4, dtype=torch.int32))
        with pytest.raises(ValueError):
            fn(_res((5, 4, 8)), mm.P21R2)            # witnesses: pass .info
        with pytest.raises(ValueError):
            fn(res, mm.ModuliSet.make((3, 5, 46349)))  # past 46340
        with pytest.raises(ValueError):
            fn(_res((9, 4, 8)), mm.ModuliSet.make(
                (3, 5, 7, 11, 13, 17, 19, 23, 29)))  # nine channels
    with pytest.raises(ValueError, match="CUDA"):
        rd.rns_decode_cuda(res, mm.P21)


def test_work_counts_bytes():
    res = torch.empty((2, 3, 5, 7), dtype=torch.int32, device="meta")
    out = torch.empty((2, 5, 7), dtype=torch.int32, device="meta")
    w = op_cost.COSTS["rns_decode"](res, mm.P21)
    assert (w.ops, w.bytes) == (0, 70 * 4 * 4)
    assert op_cost.COSTS["rns_decode"](res, mm.P21, out).bytes == 70 * 4 * 5


# ---- the runner -------------------------------------------------------------

def _profiled(fn):
    tracing.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.snapshot()["counters"]


@pytest.mark.parametrize("mset,verify", [(mm.P21, True), (mm.P21R2, False),
                                         (mm.P21R2, True)])
@pytest.mark.parametrize("stacked", [False, True])
def test_rns_local_on_cpu_is_eager(mset, verify, stacked):
    rng = np.random.default_rng(7)
    S = (2,) if stacked else ()
    M, K, N = 3, 700, 5
    a = torch.from_numpy(rng.integers(-7, 8, (*S, M, K)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-7, 8, (*S, K, N)).astype(np.int32))
    planes = runners.encode_rns_planes(w, mset)
    segs = [(0, 256), (256, 512), (512, 700)]
    got, counters = _profiled(lambda: runners._rns_local(
        a, planes, segs, mset, verify))
    want = torch.matmul(a.double(), w.double()).to(torch.int32)
    assert torch.equal(got, want)
    assert counters == {"numerics.decode_eager": 3 * want.numel()}
