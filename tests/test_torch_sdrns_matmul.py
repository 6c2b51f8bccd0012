"""Port parity: the SD-RNS kernels' plain versions (B6, B7, B8), the sd
plane encoder, ``sdrns_run``, ``nx.add`` and the sd ring ops, against the
JAX package.

The JAX side runs its Pallas kernels in interpret mode, zero-padded to its
tiles as its runners pad, or through its runners with the ``interpret``
or ``ref`` backend.  Every result is an integer digit vector or
value, so every comparison is exact: output digit vectors, not only their
values, must be the reference's.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnx
from repro.core import moduli as jm
from repro.kernels.sd_add import sd_add_pallas
from repro.kernels.sdrns_matmul import (sdrns_matmul_pallas,
                                        sdrns_matvec_pallas)
from repro.numerics import runners as jrun
from repro_torch.configs import get_config
from repro_torch.core import moduli as tm
from repro_torch.kernels import sd_add as tsa
from repro_torch.kernels import sdrns_matmul as tsm
from repro_torch.models.api import build_model
from repro_torch.numerics import api as tnx
from repro_torch.numerics import runners as trun
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant import residency as tres

from torch_threads import one_thread  # noqa: F401

WS = (1, 0, -1)                       # P21 / P16 channel order


def _digits(rng, *shape):
    return rng.integers(-1, 2, shape).astype(np.int8)


def _pad(x, axis, mult):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, -x.shape[axis] % mult)
    return np.pad(x, pad)


CASES = [(M, K, N) for K in (1, 5, 64, 129)
         for M, N in ((1, 40), (3, 7), (8, 1), (33, 40))]


@pytest.mark.parametrize("M,K,N", CASES)
def test_plain_sdrns_matmul_equals_pallas_interpret(M, K, N):
    """B6's and B7's plain version, digit for digit, against the reference
    kernels in interpret mode (odd and non-power-of-two K exercise the K
    tree's zero leaves; three channels, three wrap signs)."""
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    a, b = _digits(rng, 3, M, K, 7), _digits(rng, 3, K, N, 7)
    t = tsm.sdrns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), WS)
    assert t.dtype == torch.int8 and t.shape == (3, M, N, 7)
    bm, bn = (8, 8) if M <= 8 else (16, 8)
    ws = jnp.asarray(WS, jnp.int32)
    ap, bp = jnp.asarray(_pad(a, 1, bm)), jnp.asarray(_pad(b, 2, bn))
    j = sdrns_matmul_pallas(ap, bp, ws, bm=bm, bn=bn, interpret=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:, :M, :N])
    if M <= 8:
        j = sdrns_matvec_pallas(ap, bp, ws, bn=bn, interpret=True)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:, :M, :N])


def test_plain_sdrns_matmul_p16_and_column_blocks(monkeypatch):
    """Five digits (P16), and the plain version's column blocking (forced
    down to 3 columns a block) gives the same digits."""
    rng = np.random.default_rng(5)
    a, b = _digits(rng, 3, 9, 37, 5), _digits(rng, 3, 37, 11, 5)
    whole = tsm.sdrns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                                 WS)
    monkeypatch.setattr(tsm, "_PLAIN_BUDGET", 3 * 5 * 9 * 37 * 5)
    blocked = tsm.sdrns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                                   WS)
    assert torch.equal(whole, blocked)
    j = sdrns_matmul_pallas(jnp.asarray(_pad(a, 1, 8)),
                            jnp.asarray(_pad(b, 2, 8)),
                            jnp.asarray(WS, jnp.int32), bm=8, bn=8,
                            interpret=True)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(j)[:, :9, :11])


@pytest.mark.parametrize("n", [5, 7])
@pytest.mark.parametrize("kind", tsa.KINDS)
def test_plain_sd_add_equals_pallas_interpret(n, kind):
    rng = np.random.default_rng(n)
    x, y = _digits(rng, 300, n), _digits(rng, 300, n)
    out_n = n + 1 if kind == "plain" else n
    j = sd_add_pallas(jnp.asarray(_pad(_pad(x, 0, 256), 1, 128)),
                      jnp.asarray(_pad(_pad(y, 0, 256), 1, 128)),
                      kind=kind, n=n, bb=256, interpret=True)
    j = np.asarray(j)[:300, :out_n]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(tsa.sd_add_ref(tx, ty, kind).numpy(), j)
    raw = tnx.add(tx.reshape(3, 100, n), ty.reshape(3, 100, n), kind=kind)
    np.testing.assert_array_equal(raw.reshape(300, out_n).numpy(), j)


def test_encode_sd_planes_bit_exact():
    rng = np.random.default_rng(1)
    for shape, hi in (((64, 40), 8), ((2, 33, 17), 100),
                      ((16, 24), 2 ** 20)):
        w = rng.integers(-hi, hi + 1, shape).astype(np.int32)
        t = trun.encode_sd_planes(torch.from_numpy(w), tm.P21)
        assert t.dtype == torch.int8
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jrun.encode_sd_planes(jnp.asarray(w),
                                                        jm.P21)))


def test_encode_sd_planes_column_blocks(monkeypatch):
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.integers(-7, 8, (20, 50)).astype(np.int32))
    whole = trun.encode_sd_planes(w, tm.P21)
    monkeypatch.setattr(trun, "_ENCODE_BLOCK", 20 * 7 * 3)
    assert torch.equal(trun.encode_sd_planes(w, tm.P21), whole)


@pytest.mark.parametrize("M,K,N,layout,backend", [
    (33, 129, 40, "sd", "interpret"), (3, 300, 40, "sd", "ref"),
    (11, 70, 9, "sd_matvec", "interpret")])
def test_sdrns_run_matches_reference_and_rns(M, K, N, layout, backend):
    """The reference caps each K segment by its VMEM budget (83 terms at
    (bm, bn) = (32, 32), 267 at the matvec tile (8, 40)) and splits these
    K; the port segments by range alone (one segment).  The int32 totals
    are equal (against the reference's Pallas kernels in interpret mode
    and its digit-level ``ref`` backend), and equal the port's own rns
    matmul and the exact product."""
    rng = np.random.default_rng(M + K)
    w = rng.integers(-7, 8, (K, N)).astype(np.int32)
    a = rng.integers(-7, 8, (M, K)).astype(np.int32)
    kw = dict(max_abs_a=7, max_abs_b=7)
    jsegs = jrun.sdrns_run(jnp.asarray(a), jrun.encode_sd_planes(
        jnp.asarray(w), jm.P21), mset=jm.P21, backend=backend,
        force_matvec=layout == "sd_matvec", **kw)
    t = tnx.encode(torch.from_numpy(w),
                   tnx.EncodeSpec(layout=layout, mset=tm.P21, qbits=4))
    assert t.layout == layout and t.planes.shape == (3, K, N, 7)
    got = tnx.matmul(torch.from_numpy(a), t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsegs))
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w)
    r = tnx.encode(torch.from_numpy(w), tnx.EncodeSpec(mset=tm.P21, qbits=4))
    assert torch.equal(tnx.matmul(torch.from_numpy(a), r), got)


def _typed_pair(rng, layout, hi=500):
    vals = [rng.integers(-hi, hi + 1, (12, 10)).astype(np.int32)
            for _ in range(2)]
    t = [tnx.encode(torch.from_numpy(v), tnx.EncodeSpec(layout=layout,
                                                         mset=tm.P21))
         for v in vals]
    j = [jnx.encode(jnp.asarray(v), jnx.EncodeSpec(layout=layout,
                                                   mset=jm.P21))
         for v in vals]
    return vals, t, j


@pytest.mark.parametrize("layout", ["sd", "sd_matvec", "rns"])
def test_nx_add_typed_matches_reference(layout):
    rng = np.random.default_rng(3)
    (x, y), (tx, ty), (jx, jy) = _typed_pair(rng, layout)
    t = tnx.add(tx, ty)
    j = jnx.add(jx, jy, interpret=True)
    assert isinstance(t, ResidueTensor) and t.layout == layout
    np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
    np.testing.assert_array_equal(tnx.decode(t).numpy(), x + y)
    with pytest.raises(TypeError):
        tnx.add(tx, ty.planes)
    with pytest.raises(ValueError, match="kind="):
        tnx.add(tx, ty, kind="pow2")
    with pytest.raises(ValueError, match="kind="):
        tnx.add(tx.planes, ty.planes)


def test_sd_ring_ops_match_reference():
    rng = np.random.default_rng(4)
    (x, y), (tx, ty), (jx, jy) = _typed_pair(rng, "sd", hi=30)
    for t, j, want in ((tx + ty, jx + jy, x + y), (tx - ty, jx - jy, x - y),
                       (tx * ty, jx * jy, x * y), (-tx, -jx, -x)):
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
        np.testing.assert_array_equal(t.to_int().numpy(), want)
    assert tx.is_sd and tx.digit_width == 7 and tx.channel_axis == 0
    assert tx.shape == (12, 10)
    rns = tnx.encode(torch.from_numpy(x), tnx.EncodeSpec(mset=tm.P21))
    with pytest.raises(ValueError, match="layout mismatch"):
        tx + rns
    scaled = tnx.encode(torch.randn(8, 4),
                        tnx.EncodeSpec(layout="sd", qbits=4))
    with pytest.raises(ValueError, match="scale"):
        scaled + scaled
    with pytest.raises(ValueError, match="scale"):
        tnx.add(scaled, scaled)
    assert torch.equal(tnx.add(*(dataclasses.replace(scaled, scale=None)
                                 for _ in range(2))).to_int(),
                       2 * dataclasses.replace(scaled, scale=None).to_int())


def test_sd_layouts_reject_generic_and_redundant_sets():
    generic = tm.ModuliSet.make((127, 129, 131))
    w = torch.randint(-7, 8, (8, 4))
    for layout in ("sd", "sd_matvec"):
        with pytest.raises(ValueError, match="redundant"):
            tnx.EncodeSpec(layout=layout, mset=tm.P21R2)
        with pytest.raises(ValueError, match="special moduli set"):
            tnx.encode(w, tnx.EncodeSpec(layout=layout, mset=generic))
        with pytest.raises(ValueError, match="redundant"):
            ResidueTensor(planes=torch.zeros((5, 8, 4, 7), dtype=torch.int8),
                          mset=tm.P21R2, layout=layout)
        with pytest.raises(ValueError, match="digit width"):
            ResidueTensor(planes=torch.zeros((3, 8, 4, 5), dtype=torch.int8),
                          mset=tm.P21, layout=layout)
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(ValueError, match="rns_mset"):
        build_model(cfg, system="sdrns", rns_mset=tm.P21R2, device="cpu")
    sd = tres.prepare_weight(torch.randn(8, 4), system="sdrns")
    assert sd.layout == "sd"
    assert tres.prepare_weight(sd, system="sdrns") is sd
    with pytest.raises(ValueError, match="re-prepare"):
        tres.prepare_weight(sd, system="rns")
    rns = tres.prepare_weight(torch.randn(8, 4), system="rns")
    with pytest.raises(ValueError, match="re-prepare"):
        tres.prepare_weight(rns, system="sdrns")


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.zeros((3, 2, 16, 7), dtype=torch.int8)
    b = torch.zeros((3, 16, 8, 7), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.sdrns_matmul_cuda(a, b, WS)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.sdrns_matvec_cuda(a, b, WS)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.sd_add_cuda(a, a, "pow2")
    assert tsm.launches == {"sdrns_matmul": 0, "sdrns_matvec": 0}
    assert tsa.launches == 0
