"""Port parity: the Mamba2 (SSD) block of ``repro_torch.models.ssm``.

Mirrors ``tests/test_ssm.py`` (chunked == recurrent, chunk-size
invariance, prefill-cache continuation, cache shapes) on the port, and
holds each port function against the JAX function on the same numpy
parameters and inputs in f32 under ``bns``.  Tolerances: port against
reference ``REF_TOL`` (f32 sums in another order: torch's and XLA's CPU
einsum, cumsum and exp differ in the last ulps); the port's own
invariants at the reference's tolerances (2e-4 chunked vs recurrent,
1e-4 across chunk sizes).

Under ``rns`` the projections are exact integer matmuls: on the same
float input the port's and the reference's in/out projections agree bit
for bit (the recurrence between them stays float).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.models import linear as jlinear
from repro.models import ssm as jssm
from repro.quant import residency as jres
from repro_torch.models import linear as tlinear
from repro_torch.models import ssm as tssm
from repro_torch.quant import residency as tres

JDIMS = jssm.Mamba2Dims(d_model=32, d_state=16, d_conv=4, expand=2,
                        headdim=16)
TDIMS = tssm.Mamba2Dims(*JDIMS)
JF32 = {"system": "bns", "compute_dtype": jnp.float32}
TF32 = {"system": "bns", "compute_dtype": torch.float32}
REF_TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), JDIMS)
    tp = jtu.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = (np.random.default_rng(1).normal(size=(2, 16, 32)) * 0.5).astype(
        np.float32)
    return jp, tp, x


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _port_recurrent(tp, x, cache, t0, t1):
    outs = []
    for t in range(t0, t1):
        y, cache = tssm.mamba2_decode(tp, x[:, t:t + 1], cache, TDIMS,
                                      dense_kw=TF32)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


def test_dims_match_reference():
    assert TDIMS.d_inner == JDIMS.d_inner
    assert TDIMS.n_heads == JDIMS.n_heads
    assert TDIMS.conv_dim == JDIMS.conv_dim
    assert TDIMS.d_in_proj == JDIMS.d_in_proj
    full = tssm.Mamba2Dims(3584, 64, 4, 2, 64)       # zamba2-7b
    assert (full.d_inner, full.n_heads, full.conv_dim, full.d_in_proj) == \
        (7168, 112, 7296, 14576)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_forward_matches_reference(setup, chunk):
    jp, tp, x = setup
    j = jssm.mamba2_forward(jp, jnp.asarray(x), JDIMS, chunk=chunk,
                            dense_kw=JF32)
    t = tssm.mamba2_forward(tp, torch.from_numpy(x), TDIMS, chunk=chunk,
                            dense_kw=TF32)
    _close(t, j, REF_TOL)


def test_ragged_forward_matches_reference(setup):
    """S not a multiple of the chunk: padded and sliced, as the reference."""
    jp, tp, x = setup
    j = jssm.mamba2_forward(jp, jnp.asarray(x[:, :13]), JDIMS, chunk=8,
                            dense_kw=JF32)
    t = tssm.mamba2_forward(tp, torch.from_numpy(x[:, :13]), TDIMS,
                            chunk=8, dense_kw=TF32)
    _close(t, j, REF_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tssm.mamba2_forward(tp, torch.from_numpy(x[:, :13]), TDIMS, chunk=8,
                            dense_kw=TF32, return_cache=True)


def test_decode_matches_reference(setup):
    jp, tp, x = setup
    jc = jssm.init_ssm_cache(2, JDIMS)
    tc = tssm.init_ssm_cache(2, TDIMS, device="cpu")
    for t in range(6):
        jy, jc = jssm.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                    JDIMS, dense_kw=JF32)
        ty, tc = tssm.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                    tc, TDIMS, dense_kw=TF32)
        _close(ty, jy, REF_TOL)
        _close(tc.conv, jc.conv, REF_TOL)
        _close(tc.state, jc.state, REF_TOL)
    assert tc.conv.dtype == tc.state.dtype == torch.float32


def test_prefill_cache_matches_reference(setup):
    jp, tp, x = setup
    jy, jc = jssm.mamba2_forward(jp, jnp.asarray(x[:, :8]), JDIMS, chunk=8,
                                 dense_kw=JF32, return_cache=True)
    ty, tc = tssm.mamba2_forward(tp, torch.from_numpy(x[:, :8]), TDIMS,
                                 chunk=8, dense_kw=TF32, return_cache=True)
    _close(ty, jy, REF_TOL)
    _close(tc.conv, jc.conv, REF_TOL)
    _close(tc.state, jc.state, REF_TOL)
    # a prompt shorter than the conv history keeps the zero history ahead
    jy, jc = jssm.mamba2_forward(jp, jnp.asarray(x[:, :2]), JDIMS, chunk=8,
                                 dense_kw=JF32, return_cache=True)
    ty, tc = tssm.mamba2_forward(tp, torch.from_numpy(x[:, :2]), TDIMS,
                                 chunk=8, dense_kw=TF32, return_cache=True)
    _close(tc.conv, jc.conv, REF_TOL)
    _close(tc.state, jc.state, REF_TOL)


def test_chunked_equals_recurrent(setup):
    _, tp, x = setup
    xt = torch.from_numpy(x)
    y_chunk = tssm.mamba2_forward(tp, xt, TDIMS, chunk=8, dense_kw=TF32)
    y_rec, _ = _port_recurrent(tp, xt, tssm.init_ssm_cache(2, TDIMS,
                                                           device="cpu"),
                               0, x.shape[1])
    np.testing.assert_allclose(y_chunk.numpy(), y_rec.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_chunk_size_invariance(setup):
    _, tp, x = setup
    xt = torch.from_numpy(x)
    y8, y16, y4 = (tssm.mamba2_forward(tp, xt, TDIMS, chunk=c,
                                       dense_kw=TF32) for c in (8, 16, 4))
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y8.numpy(), y4.numpy(), rtol=1e-4, atol=1e-4)


def test_prefill_cache_continuation(setup):
    """forward(first half, return_cache) then decode(second half) equals
    forward(full sequence): the serving-prefill contract."""
    _, tp, x = setup
    xt = torch.from_numpy(x)
    y_full = tssm.mamba2_forward(tp, xt, TDIMS, chunk=8, dense_kw=TF32)
    y_half, cache = tssm.mamba2_forward(tp, xt[:, :8], TDIMS, chunk=8,
                                        dense_kw=TF32, return_cache=True)
    np.testing.assert_allclose(y_full[:, :8].numpy(), y_half.numpy(),
                               rtol=2e-4, atol=2e-4)
    y_rest, _ = _port_recurrent(tp, xt, cache, 8, 16)
    np.testing.assert_allclose(y_full[:, 8:].numpy(), y_rest.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_state_shape_and_finiteness(setup):
    _, tp, x = setup
    y, cache = tssm.mamba2_forward(tp, torch.from_numpy(x), TDIMS, chunk=8,
                                   dense_kw=TF32, return_cache=True)
    assert cache.state.shape == (2, TDIMS.n_heads, TDIMS.headdim,
                                 TDIMS.d_state)
    assert cache.conv.shape == (2, TDIMS.d_conv - 1, TDIMS.conv_dim)
    assert cache.conv.is_contiguous()
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(cache.state).all())


@pytest.mark.parametrize("name", ["in_proj", "out_proj"])
def test_rns_projections_bit_exact(setup, name):
    """The integer matmuls of the block under ``rns``: the same float input
    through the port's and the reference's resident weight, bit for bit
    (d_in_proj = 164 is not a multiple of a tile)."""
    jp, tp, _ = setup
    K = jp[name]["w"].shape[0]
    xin = (np.random.default_rng(2).normal(size=(2, 5, K))).astype(
        np.float32)
    jw = jres.prepare_dense(jp[name], system="rns", bits=4, roles=False)
    tw = tres.prepare_dense(tp[name], system="rns", bits=4)
    j = jlinear.dense(jw, jnp.asarray(xin), system="rns", bits=4,
                      compute_dtype=jnp.float32, impl="ref")
    t = tlinear.dense(tw, torch.from_numpy(xin), system="rns", bits=4,
                      compute_dtype=torch.float32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
