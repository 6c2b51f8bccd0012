"""Port parity on a (2, 2) gloo group: the column layout and the C-split
layout of the default mesh (the reference's ``tests/test_sharded_residency.py``
sections 2-5).

Four ranks (``tests/torch_mesh.py``) run the port's sharded paths; the
reference's single-device outputs come from this process.  Every residue
matmul is exact, so the sharded outputs equal the reference's bit for bit:
rns and sdrns on P21, rns on CRT40, at M 2 (the matvec route) and M 16,
under the column layout and under ``channel_shard`` (where C = 3 does not
divide the 2-rank tensor axis and the plan falls back to the gathered
layout, counted).  A row-parallel weight (K over the model axis) takes the
row plan: its K rows stay on their rank and the int32 partials are
all-reduced.  The whole decode step of a prepared reduced yi-6b on the
column layout equals the port's own single-rank logits bit for bit (the
port runs its attention kernels under both layouts) and the reference's
within the model parity tests' tolerance.  The reference's own mesh run of
that step differs from its single-device one only because the two take
different attention routes (ROADMAP §C); pinned to one route they agree
exactly.
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
from repro.launch.mesh import make_ctx as jmake_ctx
from repro.models import linear as jlinear
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.parallel.sharding import residue_specs as jresidue_specs
from repro.quant import residency as jres

import torch_mesh
from torch_threads import one_thread  # noqa: F401

LOGIT_TOL = 1e-4          # the port's model parity tests' bound
CASES = [("rns", "P21"), ("sdrns", "P21"), ("rns", "CRT40")]
KEYS = torch_mesh.dense_case_keys(CASES)
# the reference test's impl per case: its Pallas bodies in interpret mode,
# the jnp ref for the six-channel set
IMPL = {"P21": "interpret", "CRT40": "ref"}


def _ref_dense(w, x, system, mname):
    mset = getattr(jm, mname)
    prep = jres.prepare_dense({"w": jnp.asarray(w)}, system=system, bits=4,
                              mset=mset)
    return np.asarray(jlinear.dense(prep, jnp.asarray(x), system=system,
                                    mset=mset, impl=IMPL[mname],
                                    compute_dtype=jnp.float32))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    rng = np.random.default_rng(1)
    inputs = torch_mesh.dense_inputs(CASES)
    w_place = rng.normal(size=(8, 16)).astype(np.float32)
    w_crt = rng.normal(size=(12, 8)).astype(np.float32)
    jcfg = dataclasses.replace(jget_config("yi-6b").reduced(), n_layers=1,
                               d_model=16, n_heads=2, n_kv=1, d_ff=32,
                               vocab=64, head_dim=8, compute_dtype="float32")
    jmodel = jbuild_model(jcfg, system="sdrns", rns_impl="interpret")
    tree = torch_mesh.random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)), seed=2)
    raw = jax.tree_util.tree_map(jnp.asarray, tree)
    run = torch_mesh.RankRun(torch_mesh.col_body, 4,
                             tmp_path_factory.mktemp("mesh_col"), inputs,
                             w_place, w_crt, tree)
    # the reference's side while the ranks run
    ref = {"dense": {k: _ref_dense(*inputs[k], *k[:2]) for k in KEYS}}
    ref["place"] = np.asarray(jres.prepare_weight(
        jnp.asarray(w_place), system="sdrns", bits=4).planes)
    t_crt = jres.prepare_weight(jnp.asarray(w_crt), system="rns", bits=4,
                                mset=jm.CRT40)
    ref["crt40"] = np.asarray(jnx.decode(t_crt))
    prev = set_attn_impl("interpret")
    try:
        prep = jmodel.prepare_params(raw)
        logits, _ = jmodel.decode(prep, jnp.zeros((2, 1), jnp.int32),
                                  jmodel.init_cache(2, 8), jnp.int32(3))
    finally:
        set_attn_impl(prev)
    ref["logits"] = np.asarray(logits)
    amesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    ref["specs"] = {}
    for system, mname in CASES:
        t = jres.prepare_weight(jnp.asarray(inputs[(system, mname, 2)][0]),
                                system=system, bits=4,
                                mset=getattr(jm, mname))
        for name, cs in (("tp", False), ("cshard", True)):
            ctx = jmake_ctx(amesh, channel_shard=cs)
            ref["specs"][(name, system, mname)] = tuple(
                jresidue_specs(t, ["dp", "tp"], ctx).planes)
    return run.results(), ref


@pytest.mark.parametrize("layout", ["tp", "cshard"])
@pytest.mark.parametrize("key", KEYS, ids=["-".join(map(str, k))
                                           for k in KEYS])
def test_sharded_dense_equals_reference(mesh_run, key, layout):
    """Section 3: every rank's output of the sharded dense layer equals the
    reference's single-device ``linear.dense`` bit for bit, as does the
    port's own unsharded one."""
    ranks, ref = mesh_run
    want = ref["dense"][key]
    for out in ranks:
        np.testing.assert_array_equal(out["dense"][("base",) + key].numpy(),
                                      want)
        np.testing.assert_array_equal(out["dense"][(layout,) + key].numpy(),
                                      want, err_msg=f"{layout} {key}")


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_recorded_specs_equal_reference(mesh_run, case):
    """The plane specs each rank records equal the reference's
    ``residue_specs`` on an abstract (2, 2) mesh, in both layouts: TP on N
    with FSDP on K; under channel_shard C = 3 stays whole on the 2-rank
    axis (N whole too: the layouts are alternatives), CRT40's C = 6
    splits."""
    ranks, ref = mesh_run
    system, mname = case
    for name in ("tp", "cshard"):
        want = ref["specs"][(name, system, mname)]
        for out in ranks:
            assert out["specs"][(name, system, mname, 2)] == want
    if mname == "CRT40":
        assert ref["specs"][("cshard", system, mname)] == (
            "model", "data", None)


@pytest.mark.parametrize("key", KEYS, ids=["-".join(map(str, k))
                                           for k in KEYS])
def test_row_plan_keeps_k_rows_on_rank(mesh_run, key):
    """A row-parallel weight (``wo``: K over the model axis, N over data)
    takes the row plan: the kernel's block is the rank's own 12 of K's 24
    rows with N gathered over data (FSDP), so the only plane bytes moved
    are the one other data rank's block, and the all-reduced int32
    partials equal the reference's single-device ``linear.dense`` bit for
    bit."""
    ranks, ref = mesh_run
    C = 3 if key[1] == "P21" else 6
    for out in ranks:
        r = out["row"][key]
        assert r["plan"] == "row"
        assert r["spec"][:3] == (None, "model", "data")
        assert r["local"][:3] == (C, 12, 8)
        assert r["block"][:3] == (C, 12, 16)
        assert r["moved"] == {"all_gather": r["local_bytes"]}
        np.testing.assert_array_equal(r["y"].numpy(), ref["dense"][key])


def test_prepare_keeps_this_ranks_block(mesh_run):
    """Section 2: ``prepare_weight`` under a context keeps the rank's
    block of the sdrns digit planes, ``(None, data, model, None)``, the
    scale following N; the blocks gather to the reference's planes."""
    ranks, ref = mesh_run
    whole = ref["place"]                   # (C, K, N, n) = (3, 8, 16, 7)
    for out in ranks:
        p = out["place"]
        assert p["planes_spec"] == (None, "data", "model", None)
        assert p["scale_spec"] == (None, "model")
        d, m = out["coord"]["data"], out["coord"]["model"]
        np.testing.assert_array_equal(
            p["planes"].numpy(), whole[:, 4 * d:4 * d + 4, 8 * m:8 * m + 8])
        np.testing.assert_array_equal(p["whole"].numpy(), whole)
        assert tuple(p["scale"].shape) == (1, 8)


def test_c_split_round_trip(mesh_run):
    """Section 4: CRT40 planes split on C over the model axis (three
    channels a rank), K keeping FSDP, decode to the unsharded decode and
    to the reference's, exactly."""
    ranks, ref = mesh_run
    for out in ranks:
        c = out["crt40"]
        assert c["spec"] == ("model", "data", None)
        assert c["local_c"] == 3
        np.testing.assert_array_equal(c["dec_sh"].numpy(), ref["crt40"])
        np.testing.assert_array_equal(c["dec"].numpy(), ref["crt40"])


def test_column_layout_decode_equals_single_rank(mesh_run):
    """Section 5: the decode step of the prepared tree on the column
    layout equals the port's single-rank step bit for bit on every rank;
    wq's planes are ``(None, data, model, None)``, a quarter of the whole
    on each rank; wo and w_down take the row plan, the other weights the
    column plan."""
    ranks, _ = mesh_run
    for out in ranks:
        m = out["model"]
        assert m["tags"] == {"col": 6, "row": 2}
        assert m["wq_spec"] == (None, "data", "model", None)
        assert 4 * m["wq_planes"] == m["wq_whole_planes"]
        np.testing.assert_array_equal(m["logits_mesh"].numpy(),
                                      m["logits_1"].numpy())


def test_column_layout_decode_matches_reference(mesh_run):
    """Section 5 against the reference's single-device decode (its flash
    and residue kernels in interpret mode, the routes the port's kernels
    port): within the model parity bound."""
    ranks, ref = mesh_run
    for out in ranks:
        np.testing.assert_allclose(out["model"]["logits_mesh"].numpy(),
                                   ref["logits"], rtol=0, atol=LOGIT_TOL)
