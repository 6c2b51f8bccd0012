"""Port parity of ``parallel/compression.py`` and ``parallel/pipeline.py``
on gloo groups of 1, 2 and 4 ranks (``tests/torch_mesh.py``).

* One rank: the reference's two single-device cases
  (``tests/test_compression.py``: an exact passthrough, and a pre-existing
  error re-injected into the mean), against the reference's outputs.
* Two and four ranks with different gradients: the mean within half a
  quantization step of the exact mean on every rank, and the new error
  state equal to a numpy model of the same algorithm (reduce-scatter over
  n, a shared scale max|shard| / 127, int8 codes, ``n * residual`` on the
  owned rows); the scalar and a leaf whose lead does not divide n take the
  exact f32 mean with a zero error.
* ``pipeline_apply`` on 2 and 4 stages equals the sequential stack on
  every rank, and refuses fewer micro-batches than stages.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.parallel.compression import (init_error_state,
                                        make_compressed_mean)

import torch_mesh
from torch_threads import one_thread  # noqa: F401

SIZES = (1, 2, 4)
D = 8           # pipeline width; 6 micro-batches of 3 rows
# (lead, width) per leaf: "w" divides 2 and 4, "odd" divides neither
LEAVES = {"w": (8, 4), "odd": (3, 5)}


def _grads(n: int, rng) -> list[dict]:
    out = []
    for _ in range(n):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in LEAVES.items()}
        g["scalar"] = np.float32(rng.normal())
        out.append(g)
    return out


def _reference_single_cases():
    """The reference's single-device cases, run on its one-device mesh."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))
    fn = make_compressed_mean(mesh, ("data",))
    g = {"w": np.random.default_rng(0).normal(0, 1, (32, 16)).astype(
        np.float32), "scalar": np.float32(3.5)}
    out, err = fn(jax.tree_util.tree_map(jnp.asarray, g),
                  init_error_state(jax.tree_util.tree_map(jnp.asarray, g)))
    g2 = {"w": np.ones((8, 4), np.float32)}
    e2 = {"w": np.full((8, 4), 0.25, np.float32)}
    out2, _ = fn(jax.tree_util.tree_map(jnp.asarray, g2),
                 jax.tree_util.tree_map(jnp.asarray, e2))
    return (g, {k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in err.items()}, g2, e2,
            np.asarray(out2["w"]))


@pytest.fixture(scope="module")
def comp_run(tmp_path_factory):
    rng = np.random.default_rng(7)
    grads = {n: _grads(n, rng) for n in (2, 4)}
    errs = {n: [{k: (0.01 * rng.normal(size=np.shape(v))).astype(np.float32)
                 for k, v in g.items()} for g in grads[n]] for n in (2, 4)}
    g1, out1, err1, g2, e2, out2 = _reference_single_cases()
    grads[1], errs[1] = [g1], None
    stage_w = {n: (rng.normal(size=(n, D, D)) / D ** 0.5).astype(np.float32)
               for n in SIZES}
    xs = rng.normal(size=(6, 3, D)).astype(np.float32)
    run = torch_mesh.RankRun(torch_mesh.compression_body, 4,
                             tmp_path_factory.mktemp("compression"),
                             grads, errs, stage_w, xs, (g2, e2))
    ranks = run.results()
    return dict(ranks=ranks, grads=grads, errs=errs, stage_w=stage_w, xs=xs,
                ref1=(out1, err1, out2))


def test_single_rank_is_the_reference_passthrough(comp_run):
    """One rank: the mean is the gradient itself and the error stays zero,
    as the reference's single-device mean gives."""
    out = comp_run["ranks"][0]
    ref_out, ref_err, _ = comp_run["ref1"]
    mean, err = out[("mean", 1)], out[("err", 1)]
    for k in ("w", "scalar"):
        np.testing.assert_array_equal(mean[k].numpy(), ref_out[k])
        np.testing.assert_array_equal(err[k].numpy(), ref_err[k])
    np.testing.assert_array_equal(mean["w"].numpy(),
                                  comp_run["grads"][1][0]["w"])
    assert float(mean["scalar"]) == 3.5
    assert float(err["w"].abs().max()) == 0.0


def test_single_rank_reinjects_error(comp_run):
    """A pre-existing error state is added into the mean (1 + 0.25)."""
    out = comp_run["ranks"][0]
    np.testing.assert_array_equal(out["reinject"].numpy(),
                                  comp_run["ref1"][2])
    np.testing.assert_allclose(out["reinject"].numpy(), 1.25, rtol=1e-6)


def _model(grads, errs, n):
    """The algorithm in numpy: ``(mean, scale, err_new per rank)`` of the
    leaf ``w``."""
    xf = [g["w"].astype(np.float64) + e["w"] for g, e in
          zip(grads[n], errs[n])]
    total = sum(xf) / n
    rows = total.shape[0] // n
    shards = [total[i * rows:(i + 1) * rows] for i in range(n)]
    scale = max(np.abs(total).max(), 1e-12) / 127.0
    errs_new = []
    for i, sh in enumerate(shards):
        q = np.clip(np.round(sh / scale), -127, 127)
        e = np.zeros_like(total)
        e[i * rows:(i + 1) * rows] = n * (sh - q * scale)
        errs_new.append(e)
    return total, scale, errs_new


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_mean_bound_and_error_state(comp_run, n):
    exact, scale, err_model = _model(comp_run["grads"], comp_run["errs"], n)
    means = [comp_run["ranks"][r][("mean", n)] for r in range(n)]
    for r in range(n):
        np.testing.assert_array_equal(means[r]["w"].numpy(),
                                      means[0]["w"].numpy())
        assert np.abs(means[r]["w"].numpy() - exact).max() <= \
            scale / 2 * (1 + 1e-5)
        np.testing.assert_allclose(comp_run["ranks"][r][("err", n)]["w"]
                                   .numpy(), err_model[r], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_unscatterable_leaves_take_exact_f32_mean(comp_run, n):
    """The scalar and the (3, 5) leaf: the exact f32 mean (float32 sums of
    n terms), a zero error."""
    grads, errs = comp_run["grads"][n], comp_run["errs"][n]
    for k in ("odd", "scalar"):
        exact = sum(np.float64(g[k]) + e[k] for g, e in zip(grads, errs)) / n
        for r in range(n):
            out = comp_run["ranks"][r]
            np.testing.assert_allclose(out[("mean", n)][k].numpy(), exact,
                                       rtol=1e-6, atol=1e-7)
            assert float(out[("err", n)][k].abs().max()) == 0.0


def test_production_mesh_shapes(comp_run):
    """``make_production_mesh`` over the 4-rank group: ``(1, world)``
    tensor-parallel by default, ``(world // C, C)`` with ``channel=C``."""
    for out in comp_run["ranks"]:
        assert out["production"] == [((1, 4), ("data", "model")),
                                     ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("n", SIZES)
def test_pipeline_equals_sequential_stack(comp_run, n):
    """GPipe over n stages (one a rank): every rank's outputs equal the n
    stages applied in turn to each micro-batch, bit for bit (the same
    torch ops on one thread), and fewer micro-batches than stages is
    refused."""
    w = torch.as_tensor(comp_run["stage_w"][n])
    want = []
    for x in torch.as_tensor(comp_run["xs"]):
        for s in range(n):
            x = torch.tanh(x @ w[s]) + x
        want.append(x)
    want = torch.stack(want)
    for r in range(n):
        out = comp_run["ranks"][r]
        assert torch.equal(out[("pipe", n)], want)
        if n > 1:
            assert "micro-batches" in out[("short", n)]
