"""Port parity of the channel split: a (2, 3) gloo group and a (1, 5) group
(the reference's ``tests/test_sharded_residency.py`` sections 3b, 3c and
5b).

Six ranks (``tests/torch_mesh.py``) hold P21's three channels one a rank
on the (2, 3) mesh, and five of them P21R2's five on the (1, 5) mesh, where
the witness channels (131, 133) lie on ranks 3 and 4, apart from every
information channel.  Each K segment's CRT partials cross the ranks in one
int32 all-reduce and fold per segment; every result equals the reference's
single-device output bit for bit: rns and sdrns dense layers at M 2 and
16, the stacked expert einsum (B1's stack mode over S x C_loc folded
channels), a fault planted in an information channel on rank 0 corrected
through the witnesses the all-reduce brings, ``nx.scrub`` of the C-split
tensor, and the whole decode step of a prepared reduced yi-6b.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import numerics as jnx
from repro.configs import get_config as jget_config
from repro.core import moduli as jm
from repro.models import linear as jlinear
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.quant import residency as jres

import torch_mesh
from torch_threads import one_thread  # noqa: F401

LOGIT_TOL = 1e-4          # the port's model parity tests' bound
CASES = [("rns", "P21"), ("sdrns", "P21")]
KEYS = torch_mesh.dense_case_keys(CASES)


def _ref_dense(w, x, system, mname):
    """The reference's single-device dense layer, its Pallas bodies in
    interpret mode."""
    mset = getattr(jm, mname)
    prep = jres.prepare_dense({"w": jnp.asarray(w)}, system=system, bits=4,
                              mset=mset)
    return np.asarray(jlinear.dense(prep, jnp.asarray(x), system=system,
                                    mset=mset, impl="interpret",
                                    compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    rng = np.random.default_rng(3)
    inputs = torch_mesh.dense_inputs(CASES, seed=4)
    w_r = (rng.normal(size=(24, 16)) * 0.2).astype(np.float32)
    x_r = rng.normal(size=(2, 24)).astype(np.float32)
    qa = rng.integers(-7, 8, (3, 4, 24)).astype(np.int32)
    wst = rng.normal(size=(3, 24, 16)).astype(np.float32)
    jcfg = dataclasses.replace(jget_config("yi-6b").reduced(), n_layers=1,
                               d_model=16, n_heads=2, n_kv=1, d_ff=32,
                               vocab=64, head_dim=8, compute_dtype="float32")
    jmodel = jbuild_model(jcfg, system="rns", rns_impl="interpret")
    tree = torch_mesh.random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)), seed=5)
    run = torch_mesh.RankRun(torch_mesh.chan_body, 6,
                             tmp_path_factory.mktemp("mesh_chan"), inputs,
                             w_r, x_r, qa, wst, tree)
    # the reference's single-device side while the ranks run
    ref = {"dense": {k: _ref_dense(*inputs[k], *k[:2]) for k in KEYS}}
    ref["einsum"] = np.asarray(jnx.einsum(
        "emk,ekn->emn", jnp.asarray(qa),
        jres.prepare_weight(jnp.asarray(wst), system="rns", bits=4)))
    ref["p21r2"] = _ref_dense(w_r, x_r, "rns", "P21R2")
    prev = set_attn_impl("interpret")
    try:
        raw = jax.tree_util.tree_map(jnp.asarray, tree)
        logits, _ = jmodel.decode(jmodel.prepare_params(raw),
                                  jnp.zeros((2, 1), jnp.int32),
                                  jmodel.init_cache(2, 8), jnp.int32(3))
    finally:
        set_attn_impl(prev)
    ref["logits"] = np.asarray(logits)
    ranks = run.results()
    # the reference's scrub of the same corrupted planes, gathered whole
    t_r = jres.prepare_weight(jnp.asarray(w_r), system="rns", bits=4,
                              mset=jm.P21R2)
    fixed, det, cor = jnx.scrub(t_r._with_planes(
        jnp.asarray(ranks[0]["p21r2"]["bad"].numpy())))
    ref["scrub"] = (np.asarray(fixed.planes), det, cor)
    ref["clean"] = np.asarray(t_r.planes)
    return ranks, ref


@pytest.mark.parametrize("key", KEYS, ids=["-".join(map(str, k))
                                           for k in KEYS])
def test_channel_plan_equals_reference(mesh_run, key):
    """Section 3b: on (2, 3) the plan is ``"chan"``, each rank holds one
    of P21's channels, and every rank's output equals the reference's
    single-device ``linear.dense`` bit for bit (rns through B1's plain
    version, sdrns through B6 at M 16 and B7 at M 2)."""
    ranks, ref = mesh_run
    for out in ranks:
        assert out["plans"][key] == "chan"
        assert out["local_channels"] == 1
        np.testing.assert_array_equal(out["dense"][("base",) + key].numpy(),
                                      ref["dense"][key])
        np.testing.assert_array_equal(out["dense"][("chan",) + key].numpy(),
                                      ref["dense"][key], err_msg=str(key))


def test_stacked_einsum_rides_channel_plan(mesh_run):
    """The stacked einsum on C-split planes ``(None, model, data, None)``
    equals the unsharded einsum and the reference's, exactly."""
    ranks, ref = mesh_run
    for out in ranks:
        e = out["einsum"]
        assert e["spec"] == (None, "model", "data", None)
        np.testing.assert_array_equal(e["y_sh"].numpy(), ref["einsum"])
        np.testing.assert_array_equal(e["y"].numpy(), ref["einsum"])


def test_channel_layout_decode(mesh_run):
    """Section 5b: the whole decode step of the prepared tree under
    channel_shard equals the single-rank step bit for bit on every rank,
    and the reference's (interpret mode) within the model parity bound."""
    ranks, ref = mesh_run
    for out in ranks:
        m = out["model"]
        np.testing.assert_array_equal(m["logits_c"].numpy(),
                                      m["logits_1"].numpy())
        np.testing.assert_allclose(m["logits_c"].numpy(), ref["logits"],
                                   rtol=0, atol=LOGIT_TOL)


def test_p21r2_witness_split(mesh_run):
    """Section 3c: on (1, 5) each rank holds one P21R2 channel, the
    witnesses on ranks 3 and 4; the checked decode through the all-reduced
    witnesses equals the reference's single-device output bit for bit."""
    ranks, ref = mesh_run
    for out in ranks[:5]:
        p = out["p21r2"]
        assert p["plan"] == "chan" and p["local_c"] == 1
        assert p["spec"] == ("model", "data", None)
        np.testing.assert_array_equal(p["y_base"].numpy(), ref["p21r2"])
        np.testing.assert_array_equal(p["y_sh"].numpy(), ref["p21r2"])


def test_fault_corrected_through_allreduce(mesh_run):
    """An information channel's plane corrupted on rank 0 alone: the
    witness syndromes the all-reduce assembles from ranks 3 and 4 rebuild
    the value, and every rank's output equals the fault-free one."""
    ranks, ref = mesh_run
    for out in ranks[:5]:
        np.testing.assert_array_equal(out["p21r2"]["y_bad"].numpy(),
                                      ref["p21r2"])


def test_scrub_of_c_split_tensor(mesh_run):
    """``nx.scrub`` of the C-split tensor finds and repairs the fault with
    the unsharded scrub's counts and planes, the reference's too; each
    rank keeps its channel of the repaired planes."""
    ranks, ref = mesh_run
    fixed_ref, det_r, cor_r = ref["scrub"]
    np.testing.assert_array_equal(fixed_ref, ref["clean"])
    for r, out in enumerate(ranks[:5]):
        p = out["p21r2"]
        assert p["counts_sh"] == p["counts_1"] == (det_r, cor_r)
        assert det_r >= 1
        np.testing.assert_array_equal(p["fixed_sh"].numpy(), fixed_ref)
        np.testing.assert_array_equal(p["fixed_1"].numpy(), fixed_ref)
        np.testing.assert_array_equal(p["fixed_local"].numpy(),
                                      fixed_ref[r:r + 1])
