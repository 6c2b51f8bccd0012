"""Port parity of the sharding rules, in one process (no ranks).

Specs need only a mesh's axis sizes, so both packages run on abstract
meshes: ``jax.sharding.AbstractMesh`` and the port's
``parallel.sharding.AbstractMesh``, (2, 2) and (2, 3) over ``("data",
"model")``.  Held against the reference: every spec that sections 1 and 4
of its ``tests/test_sharded_residency.py`` assert; ``param_specs`` over the
whole reduced qwen3-8b and moonshot trees, float and prepared (the port
keeps its layers as a list, so each layer's specs are the reference's
stacked ones without their leading None); ``leaf_roles``;
``cache_roles``; ``tp_shard_plan``'s tags and its three fallbacks; the
partial-CRT methods of ``core/moduli.py`` bit for bit on random residues.
"""
from __future__ import annotations

import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import moduli as jm
from repro.launch.mesh import make_ctx as jmake_ctx
from repro.models.api import build_model as jbuild_model
from repro.numerics import runners as jrun
from repro.parallel import sharding as jsh
from repro.quant import residency as jres
from repro_torch.configs import get_config
from repro_torch.core import moduli as tm
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import build_model
from repro_torch.numerics import runners as trun
from repro_torch.parallel import sharding as tsh
from repro_torch.quant import residency as tres

from torch_threads import one_thread  # noqa: F401

SHAPES = [(2, 2), (2, 3)]


def _ctxs(shape, channel_shard=False):
    jmesh = jax.sharding.AbstractMesh(shape, ("data", "model"))
    tmesh_ = tsh.AbstractMesh(shape, ("data", "model"))
    return (jmake_ctx(jmesh, channel_shard=channel_shard),
            tmesh.make_ctx(tmesh_, channel_shard=channel_shard))


def _w(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _prep(w, system, mset="P21"):
    return (jres.prepare_weight(jnp.asarray(w), system=system, bits=4,
                                mset=getattr(jm, mset)),
            tres.prepare_weight(torch.as_tensor(w), system=system, bits=4,
                                mset=getattr(tm, mset)))


# ---- section 1: typed specs over ResidueTensor leaves ----------------------

def test_section1_typed_specs():
    """The reference test's literal specs, on the port and the reference."""
    jctx, tctx = _ctxs((2, 2))
    jctx_c, tctx_c = _ctxs((2, 2), channel_shard=True)
    jt, tt = _prep(_w(3, 8, 16), "sdrns")
    for name, want in (("wq", (None, None, "data", "model", None)),
                       ("wo", (None, None, "model", "data", None))):
        js = jsh.param_specs({"layers": {"attn": {name: {"w": jt}}}},
                             jctx)["layers"]["attn"][name]["w"]
        ts = tsh.param_specs({"layers": {"attn": {name: {"w": tt}}}},
                             tctx)["layers"]["attn"][name]["w"]
        assert tuple(ts.planes) == tuple(js.planes) == want
        assert tuple(ts.scale) == tuple(js.scale)
    ts = tsh.param_specs({"layers": {"attn": {"wq": {"w": tt}}}},
                         tctx)["layers"]["attn"]["wq"]["w"]
    assert tuple(ts.scale) == (None, None, "model")
    # channel split: C = 3 does not divide 2 -> channels and N whole
    js = jsh.param_specs({"layers": {"attn": {"wq": {"w": jt}}}},
                         jctx_c)["layers"]["attn"]["wq"]["w"]
    ts = tsh.param_specs({"layers": {"attn": {"wq": {"w": tt}}}},
                         tctx_c)["layers"]["attn"]["wq"]["w"]
    assert tuple(ts.planes) == tuple(js.planes) == (None, None, "data",
                                                    None, None)
    # CRT40 (C = 6) on model = 2 splits its channels; the channel role is
    # stripped from every other dim, other roles survive
    jt6, tt6 = _prep(_w(3, 8, 16), "rns", "CRT40")
    for roles, want in (([None, "dp", "tp"], (None, "model", "data", None)),
                        (["tp", "dp", None], (None, "model", "data", None)),
                        (["tp", "tp", "dp"], (None, "model", None, "data"))):
        js = jsh.residue_specs(jt6, roles, jctx_c)
        ts = tsh.residue_specs(tt6, roles, tctx_c)
        assert tuple(ts.planes) == tuple(js.planes) == want
        assert tuple(ts.scale) == tuple(js.scale)


def test_section4_c_split_spec():
    """CRT40's C-split planes of a (12, 8) weight: C over model, K keeping
    FSDP, N whole."""
    jctx_c, tctx_c = _ctxs((2, 2), channel_shard=True)
    jt, tt = _prep(_w(12, 8), "rns", "CRT40")
    want = ("model", "data", None)
    assert tuple(tsh.residue_specs(tt, ["dp", "tp"], tctx_c).planes) == want
    assert tuple(jsh.residue_specs(jt, ["dp", "tp"], jctx_c).planes) == want


# ---- param_specs over whole reduced trees ----------------------------------

def _jtuples(node):
    """The reference's spec tree as plain tuples (ResidueTensor nodes as
    ("rt", planes, scale))."""
    if isinstance(node, dict):
        return {k: _jtuples(v) for k, v in node.items()}
    if hasattr(node, "planes"):
        return ("rt", tuple(node.planes),
                None if node.scale is None else tuple(node.scale))
    return tuple(node)


def _ttuples(node):
    if isinstance(node, dict):
        return {k: _ttuples(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_ttuples(v) for v in node]
    if isinstance(node, tsh.ResidueSpecs):
        return ("rt", tuple(node.planes),
                None if node.scale is None else tuple(node.scale))
    return tuple(node)


def _unstack(node):
    """Drop the leading stack entry of every spec (one layer's specs)."""
    if isinstance(node, dict):
        return {k: _unstack(v) for k, v in node.items()}
    if node[0] == "rt":
        return ("rt", node[1][1:], None if node[2] is None else node[2][1:])
    return node[1:]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ("qwen3-8b", "moonshot-v1-16b-a3b"):
        jm_ = jbuild_model(jget_config(arch).reduced(), system="rns")
        shapes = jax.eval_shape(jm_.init, jax.random.PRNGKey(0))
        pshapes = jax.eval_shape(jm_.prepare_params, shapes)
        tm_ = build_model(get_config(arch).reduced(), system="rns",
                          device="cpu")
        raw = tm_.init(0, prepare=False)
        out[arch] = dict(j=(shapes, pshapes),
                         t=(raw, tm_.prepare_params(raw)))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b"])
def test_param_specs_whole_tree(trees, arch, prepared, shape):
    """``param_specs`` of the port's reduced tree equals the reference's,
    leaf by leaf: each of the port's per-layer trees against the
    reference's stacked specs without the stack entry."""
    jctx, tctx = _ctxs(shape)
    jtree, ttree = trees[arch]["j"][prepared], trees[arch]["t"][prepared]
    js = _jtuples(jsh.param_specs(jtree, jctx))
    ts = _ttuples(tsh.param_specs(ttree, tctx))
    layers = js.pop("layers")
    t_layers = ts.pop("layers")
    assert ts == js
    for lay in t_layers:
        assert lay == _unstack(layers)


def test_param_specs_rule_on_stacked_leaves():
    """A leaf under ``layers`` that carries its stack axis (the reference's
    layout, a dict rather than the port's list) gets the leading None, and
    an expert stack takes EP where E divides tp."""
    jctx, tctx = _ctxs((2, 2))
    tree = {"layers": {"moe": {"w_up": np.zeros((3, 4, 8, 6), np.float32)},
                       "attn": {"wq": {"w": np.zeros((3, 8, 6),
                                                     np.float32)}}},
            "embed": {"table": np.zeros((10, 8), np.float32)}}
    js = _jtuples(jsh.param_specs(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jctx))
    ts = _ttuples(tsh.param_specs(tree, tctx))
    assert ts == js
    assert js["layers"]["moe"]["w_up"] == (None, "model", "data", None)


# ---- leaf_roles -------------------------------------------------------------

ROLES = [["dp", "tp"], ["tp", "dp"], [None, "tp"], [("dp", "tp"), None],
         ["tp", ("dp", "tp")]]


@pytest.mark.parametrize("channel_role", [None, "tp"])
@pytest.mark.parametrize("system", ["rns", "sdrns"])
def test_leaf_roles(system, channel_role):
    jt, tt = _prep(_w(8, 6), system)
    for roles in ROLES:
        assert tt.leaf_roles(roles, channel_role=channel_role) == \
            jt.leaf_roles(roles, channel_role=channel_role)
    jts, tts = _prep(_w(3, 8, 6), system)
    for roles in ([None, "dp", "tp"], ["tp", "dp", None]):
        assert tts.leaf_roles(roles, channel_role=channel_role) == \
            jts.leaf_roles(roles, channel_role=channel_role)
    with pytest.raises(ValueError):
        tt.leaf_roles(["dp"])


# ---- cache_roles ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-7b", "mamba2-780m",
                                  "whisper-small"])
@pytest.mark.parametrize("batch", [1, 2])
def test_cache_roles(arch, batch):
    jmodel = jbuild_model(jget_config(arch).reduced(), system="bns")
    tmodel = build_model(get_config(arch).reduced(), system="bns",
                         device="cpu")
    jc = jax.eval_shape(lambda: jmodel.init_cache(batch, 8))
    tc = tmodel.init_cache(batch, 8)

    def flat(node):
        if isinstance(node, dict):
            return {k: flat(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {f: flat(getattr(node, f)) for f in node._fields}
        return node.roles

    troles = tmodel.cache_roles(tc)
    assert flat(troles) == flat(jmodel.cache_roles(jc))
    # the roles' specs on an abstract (2, 2) mesh (the divisibility drop
    # decides batch 1)
    jctx, tctx = _ctxs((2, 2))
    jspecs = jsh.specs_from_roles(jc, jmodel.cache_roles(jc), jctx)
    tspecs = tsh.specs_from_roles(tc, troles, tctx)

    def tuples(node):
        if isinstance(node, dict):
            return {k: tuples(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {f: tuples(getattr(node, f)) for f in node._fields}
        return tuple(node)

    assert tuples(tspecs) == tuples(jspecs)


# ---- the planner -------------------------------------------------------------

def _plan(pkg_plan, ctx_install, ctx, *args, **kw):
    with ctx_install(ctx):
        p = pkg_plan(*args, **kw)
    return None if p is None else (p[0], tuple(p[2]), tuple(p[3]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("M,N", [(16, 16), (3, 16), (16, 15), (12, 12)])
def test_tp_shard_plan_tags(shape, M, N):
    """Tags, dp and tp names of the port's plans equal the reference's in
    both layouts (dp drops to () where M does not divide; the column plan
    needs N % tp == 0; the channel plan C % tp == 0)."""
    for cs in (False, True):
        jctx, tctx = _ctxs(shape, channel_shard=cs)
        for mset in ("P21", "P21R2", "KV8"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jp = _plan(jrun.tp_shard_plan, jsh.shard_ctx, jctx, M, N,
                           mset=getattr(jm, mset))
                tp = _plan(trun.tp_shard_plan, tsh.shard_ctx, tctx, M, N,
                           mset=getattr(tm, mset))
            assert tp == jp, (cs, mset)
    assert _plan(trun.tp_shard_plan, tsh.shard_ctx, None, M, N) is None


def test_tp_shard_plan_fallbacks_warn_and_count():
    """The three channel-split fallbacks: no moduli set, C not dividing
    the tensor axis, a set past the int32 partial-CRT bound; each a
    UserWarning and one count, as in the reference."""
    _, tctx = _ctxs((2, 2))
    assert _plan(trun.tp_shard_plan, tsh.shard_ctx, tctx, 16, 16,
                 mset=tm.P21) == ("col", ("data",), ("model",))
    _, tctx_c = _ctxs((2, 2), channel_shard=True)
    base = trun.fallback_gather_count()
    with tsh.shard_ctx(tctx_c), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert trun.tp_shard_plan(16, 16) is None
        assert trun.tp_shard_plan(16, 16, mset=tm.P21) is None
        assert trun.tp_shard_plan(16, 16, mset=tm.CRT40) is None
    assert len(rec) == 3
    assert all(issubclass(w.category, UserWarning) for w in rec)
    assert trun.fallback_gather_count() == base + 3
    _, tctx23 = _ctxs((2, 3), channel_shard=True)
    assert _plan(trun.tp_shard_plan, tsh.shard_ctx, tctx23, 2, 16,
                 mset=tm.P21) == ("chan", ("data",), ("model",))


# ---- the partial CRT ---------------------------------------------------------

SETS = ["P16", "P21", "P21R2", "P24", "KV8", "KV8R2"]


@pytest.mark.parametrize("name", SETS + ["P33", "CRT40"])
def test_supports_partial_decode(name):
    assert getattr(tm, name).supports_partial_decode == \
        getattr(jm, name).supports_partial_decode
    if not getattr(tm, name).supports_partial_decode:
        with pytest.raises(ValueError):
            getattr(tm, name).partial_decode(torch.zeros((1, 2), dtype=torch.int32), [0])


@pytest.mark.parametrize("name", SETS)
def test_partial_crt_bit_for_bit(name):
    """``partial_decode`` / ``partial_witnesses`` of lazy residues (any
    representative) on every channel split, ``fold_partials`` of their
    sums, and ``corrected_fold`` of a planted information-channel fault,
    against the reference's; the folds equal the encoded values."""
    T, R = getattr(tm, name), getattr(jm, name)
    rng = np.random.default_rng(SETS.index(name))
    C = T.num_channels
    x = rng.integers(-T.half_range, T.half_range + 1, (5, 7)).astype(
        np.int32)
    res = np.asarray(R.to_residues(jnp.asarray(x)))
    mods = np.asarray(T.moduli, np.int32).reshape(-1, 1, 1)
    lazy = res + rng.integers(-3, 4, res.shape).astype(np.int32) * mods
    splits = [list(range(C))] + [[c] for c in range(C)]
    if C % 2 == 0:
        splits += [list(range(c, c + C // 2)) for c in (0, C // 2)]
    for cid in splits:
        a = np.asarray(R.partial_decode(jnp.asarray(lazy[cid]),
                                        jnp.asarray(cid, jnp.int32)))
        b = T.partial_decode(torch.as_tensor(lazy[cid]), cid).numpy()
        np.testing.assert_array_equal(b, a)
        a = np.asarray(R.partial_witnesses(jnp.asarray(lazy[cid]),
                                           jnp.asarray(cid, jnp.int32)))
        b = T.partial_witnesses(torch.as_tensor(lazy[cid]), cid).numpy()
        np.testing.assert_array_equal(b, a)
    total = sum(T.partial_decode(torch.as_tensor(lazy[[c]]), [c])
                for c in range(C))
    fold = T.fold_partials(total).numpy()
    np.testing.assert_array_equal(fold, np.asarray(R.fold_partials(
        jnp.asarray(total.numpy()))))
    np.testing.assert_array_equal(fold, x)
    if T.redundant >= 2:
        bad = lazy.copy()
        bad[1, 2, 3] += 5
        total = sum(T.partial_decode(torch.as_tensor(bad[[c]]), [c])
                    for c in range(C))
        wit = sum(T.partial_witnesses(torch.as_tensor(bad[[c]]), [c])
                  for c in range(C))
        y = T.corrected_fold(total, wit).numpy()
        np.testing.assert_array_equal(y, np.asarray(R.corrected_fold(
            jnp.asarray(total.numpy()), jnp.asarray(wit.numpy()))))
        np.testing.assert_array_equal(y, x)


def test_crt40_copy():
    assert tm.CRT40.moduli == jm.CRT40.moduli
    assert tm.CRT40.num_channels == 6 and not tm.CRT40.redundant


# ---- the rest of the surface -------------------------------------------------

def test_engine_under_a_mesh_serves_the_dense_cache():
    """Under a shard context the engine takes the dense cache (a paged
    request falls back to it, as the reference's does), refuses ``spec=``,
    and counts the channel-split fallbacks since it was made."""
    from repro_torch.serving.engine import ServingEngine

    model = build_model(get_config("qwen3-8b").reduced(), system="bns",
                        device="cpu")
    params = model.init(0)
    _, tctx = _ctxs((2, 3), channel_shard=True)
    with tsh.shard_ctx(tctx):
        eng = ServingEngine(model, params, batch=2, s_max=16, device="cpu")
        assert not eng.paged and eng.pool is None
        assert not ServingEngine(model, params, batch=2, s_max=16,
                                 device="cpu", paged=True).paged
        with pytest.raises(ValueError, match="mesh"):
            ServingEngine(model, params, batch=2, s_max=16, device="cpu",
                          spec="ngram:2")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trun.tp_shard_plan(2, 16, mset=tm.P16.with_redundancy((17,)))
    eng._sync_fallback_gathers()
    assert eng.stats.fallback_gathers == 1
    assert ServingEngine(model, params, batch=2, s_max=16,
                         device="cpu").paged


def test_ctx_resolve_and_small_helpers():
    jctx, tctx = _ctxs((2, 3))
    for role in ("dp", "tp", "seq", ("dp", "tp"), None, "model"):
        assert tctx.resolve(role) == jctx.resolve(role)
        assert tctx.axis_size(role) == jctx.axis_size(role)
    for shape, roles in (((4, 6), ("dp", "tp")), ((3, 6), ("tp", "dp")),
                         ((12,), (("dp", "tp"),))):
        assert tuple(tsh.logical_to_spec(tctx, shape, roles)) == \
            tuple(jsh.logical_to_spec(jctx, shape, roles))
    assert tuple(tsh.batch_spec_train(tctx)) == \
        tuple(jsh.batch_spec_train(jctx))
    pod = tmesh.make_ctx(tsh.AbstractMesh((2, 4, 4), ("pod", "data",
                                                      "model")))
    assert pod.dp == ("pod", "data") and pod.tp == ("model",)
    spec = tsh.Spec(None, "data", ("data", "model"))
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert tmesh.choose_backend(2) == ("nccl" if torch.cuda.device_count()
                                       >= 2 else "gloo")
