"""Port parity: the residue matmul kernel's plain version, ``nx.matmul`` and
weight preparation, bit for bit against the JAX package.

The JAX side runs its Pallas kernel in interpret mode where the grid is
small, and its ``ref`` backend (the same exact integer semantics) for the
larger shapes, as its own tests do.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnx
from repro.core.moduli import P21 as JP21
from repro.kernels.rns_matmul import rns_matmul_pallas
from repro.quant import residency as jres
from repro_torch.core.moduli import P21
from repro_torch.kernels import rns_matmul as trm
from repro_torch.numerics import api as tnx
from repro_torch.numerics import runners as truns
from repro_torch.quant import residency as tres

from torch_threads import one_thread  # noqa: F401


def _planes(rng, C, M, K, N, moduli=(127, 128, 129)):
    half = np.array(moduli).reshape(-1, 1, 1) // 2
    a = rng.integers(-half, half + 1, (C, M, K)).astype(np.int8)
    b = rng.integers(-half, half + 1, (C, K, N)).astype(np.int8)
    return a, b


@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (8, 512, 256)])
def test_plain_rns_matmul_equals_pallas_interpret(M, K, N):
    rng = np.random.default_rng(M + K)
    a, b = _planes(rng, 3, M, K, N)
    j = rns_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(JP21.moduli, jnp.int32), bm=8, bn=128,
                          bk=128, interpret=True)
    t = trm.rns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                           P21.moduli)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_plain_rns_matmul_extreme_accumulators():
    """All residues at +/-64: the int32 accumulators reach 64*64*K, where a
    truncating rem differs from a floored one on negative sums."""
    a = np.full((3, 8, 512), 64, np.int8)
    a[:, ::2] = -64
    b = np.full((3, 512, 128), 64, np.int8)
    j = rns_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(JP21.moduli, jnp.int32), bm=8, bn=128,
                          bk=128, interpret=True)
    t = trm.rns_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                           P21.moduli)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_plain_rns_matmul_takes_segment_views():
    """The runner passes K segments as strided views (no per-call copy)."""
    rng = np.random.default_rng(7)
    a, b = _planes(rng, 3, 5, 300, 70)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    view = trm.rns_matmul_ref(at[:, :, 128:256], bt[:, 128:256, :],
                              P21.moduli)
    copy = trm.rns_matmul_ref(at[:, :, 128:256].contiguous(),
                              bt[:, 128:256, :].contiguous(), P21.moduli)
    np.testing.assert_array_equal(view.numpy(), copy.numpy())


def _weights(rng, K, N, bits):
    qmax = (1 << (bits - 1)) - 1
    return rng.integers(-qmax, qmax + 1, (K, N)).astype(np.int32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,K,N", [(3, 300, 96), (40, 520, 72)],
                         ids=["decode", "prefill"])
def test_nx_matmul_bit_exact(bits, M, K, N):
    rng = np.random.default_rng(bits * 100 + M)
    qmax = (1 << (bits - 1)) - 1
    w = _weights(rng, K, N, bits)
    a = rng.integers(-qmax, qmax + 1, (M, K)).astype(np.int32)
    jt = jnx.encode(jnp.asarray(w), jnx.EncodeSpec(layout="rns", mset=JP21,
                                                   qbits=bits))
    tt = tnx.encode(torch.from_numpy(w), tnx.EncodeSpec(layout="rns",
                                                        mset=P21, qbits=bits))
    np.testing.assert_array_equal(tt.planes.numpy(), np.asarray(jt.planes))
    segs = truns.segment_count(K, qmax, qmax, P21)
    if bits == 8:
        assert segs > 1
    j = jnx.matmul(jnp.asarray(a), jt, backend="ref")
    t = tnx.matmul(torch.from_numpy(a), tt)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        t.numpy(), a.astype(np.int64) @ w.astype(np.int64))


def test_nx_matmul_bit_exact_interpret_kernel():
    """One case through the reference's Pallas kernel itself."""
    rng = np.random.default_rng(11)
    w = _weights(rng, 200, 40, 4)
    a = rng.integers(-7, 8, (3, 200)).astype(np.int32)
    spec = jnx.EncodeSpec(layout="rns", mset=JP21, qbits=4)
    j = jnx.matmul(jnp.asarray(a), jnx.encode(jnp.asarray(w), spec),
                   backend="interpret")
    t = tnx.matmul(torch.from_numpy(a), tnx.encode(
        torch.from_numpy(w), tnx.EncodeSpec(layout="rns", qbits=4)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_nx_matmul_int8_bound_segment_overflow_matches_reference():
    """At the int8 bound the reference's segment length is rounded up to 128
    past the dynamic-range cap (65 terms for P21), so a segment of 128
    maximal terms wraps modulo M.  The port keeps the reference's segment
    boundaries, so both agree bit for bit (and both differ from the exact
    product; see ROADMAP section C)."""
    K, N = 300, 8
    w = np.full((K, N), 127, np.int32)
    a = np.full((2, K), 127, np.int32)
    spec_j = jnx.EncodeSpec(layout="rns", mset=JP21, qbits=8)
    j = jnx.matmul(jnp.asarray(a), jnx.encode(jnp.asarray(w), spec_j),
                   backend="ref")
    t = tnx.matmul(torch.from_numpy(a), tnx.encode(
        torch.from_numpy(w), tnx.EncodeSpec(layout="rns", qbits=8)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (t.numpy() != K * 127 * 127).all()


@pytest.mark.parametrize("shape", [(64, 96), (2, 96, 64)])
def test_prepare_weight_planes_and_scale_bit_exact(shape):
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.3, shape).astype(np.float32)
    j = jres.prepare_weight(jnp.asarray(w), system="rns", bits=4)
    t = tres.prepare_weight(torch.from_numpy(w), system="rns", bits=4)
    assert t.planes.dtype == torch.int8
    np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.qbits, t.max_abs, t.layout) == (j.qbits, j.max_abs, j.layout)
    np.testing.assert_array_equal(tnx.decode(t).numpy(),
                                  np.asarray(jnx.decode(j)))
