"""The port's training path against the JAX package: the token pipeline,
the optimizer, the per-call residue matmul with its straight-through
backward, micro-batching, checkpoints in the reference's npz layout,
restarts, the training CLI and the unprepared (per-call) serving path.

The reference runs eagerly here (``jax.disable_jit()`` around its model
functions): compiled, its quantizer's ``amax / qmax`` becomes a multiply
by the reciprocal, one ulp off (``test_torch_train_families.py``).  Its
residue matmuls run on the exact ``ref`` backend.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import linear as jlinear
from repro.models.api import build_model as jbuild_model
from repro.quant import residency as jresidency
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz, to_jax_params
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import linear
from repro_torch.models.api import build_model
from repro_torch.quant import residency
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.ft import (FtConfig, SimulatedFailure, run_training,
                                  run_with_restarts)
from repro_torch.train.loop import loss_and_grads, make_train_step

from torch_threads import one_thread  # noqa: F401

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                        "qwen3-8b")
OPT = optimizer.OptConfig(peak_lr=3e-3, warmup_steps=2, total_steps=40)


def _assert_tree_equal(a, b):
    """Same structure, same dtypes, equal arrays."""
    assert jtu.tree_structure(a) == jtu.tree_structure(b)
    for (path, x), y in zip(jtu.tree_flatten_with_path(a)[0],
                            jtu.tree_leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype, jtu.keystr(path)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jtu.keystr(path))


# ---------------------------------------------------------------------------
# Data and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=16, global_batch=4, seed=0),
    dict(vocab=151936, seq_len=33, global_batch=3, seed=7, noise=0.2),
    dict(vocab=128, seq_len=8, global_batch=6, seed=2, host_id=1,
         n_hosts=3)])
def test_token_pipeline_matches_reference(kw):
    ours, ref = TokenPipeline(**kw), JTokenPipeline(**kw)
    for step in (0, 3, 100):
        b, r = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == r[k].dtype and b[k].shape == r[k].shape
            np.testing.assert_array_equal(b[k], r[k])


def test_lr_at_matches_reference():
    cfg = optimizer.OptConfig(peak_lr=3e-4, warmup_steps=100,
                              total_steps=10_000)
    jcfg = jopt.OptConfig(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    steps = [0, 1, 50, 99, 100, 101, 777, 5000, 9999, 10_000, 20_000]
    got = [float(optimizer.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(jopt.lr_at(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[-1] == pytest.approx(3e-5, rel=1e-6)


@pytest.mark.parametrize("moments,n_steps", [("float32", 2),
                                             ("bfloat16", 1)])
def test_global_norm_and_adamw_match_reference(moments, n_steps):
    """AdamW steps on the reduced qwen3 tree: clipping engaged (the
    gradients' norm is ~40 against a clip of 1), decay on the stacked
    leaves (the per-layer norm scales too) and not on the final norm,
    moments in ``moment_dtype``.  Norm, learning rate, parameters and f32
    moments within 1e-6; bf16 moments within one bf16 rounding of the
    f32 values, which differ in their last bits (one step: a second would
    feed a moment one bf16 ulp apart into the update)."""
    jm = jbuild_model(jget_config("qwen3-8b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    grads = [jtu.tree_map(lambda a: np.asarray(
        rng.normal(size=a.shape) * 0.1, np.float32), jp)
        for _ in range(n_steps)]
    cfg = get_config("qwen3-8b").reduced()
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=5,
              moment_dtype=moments)
    jcfg, tcfg = jopt.OptConfig(**kw), optimizer.OptConfig(**kw)
    tp = from_jax_params(jtu.tree_map(np.asarray, jp), cfg, "cpu")
    jst, tst = jopt.init_opt_state(jp, jcfg), optimizer.init_opt_state(
        tp, tcfg)
    for g in grads:
        tg = from_jax_params(g, cfg, "cpu")
        np.testing.assert_allclose(float(optimizer.global_norm(tg)),
                                   float(jopt.global_norm(g)), rtol=1e-6)
        jp, jst, jm_ = jopt.adamw_update(jp, jtu.tree_map(jnp.asarray, g),
                                         jst, jcfg)
        tp, tst, tm_ = optimizer.adamw_update(tp, tg, tst, tcfg)
        assert float(tm_["grad_norm"]) > 10 * kw["peak_lr"] * 100
        np.testing.assert_allclose(float(tm_["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
    mtol = 2.0 ** -7 if moments == "bfloat16" else 1e-6
    for got, want, rtol in ((to_jax_params(tp), jp, 1e-6),
                            (to_jax_params(tst["m"]), jst["m"], mtol),
                            (to_jax_params(tst["v"]), jst["v"], mtol)):
        for (path, w) in jtu.tree_flatten_with_path(want)[0]:
            g = got
            for p in path:
                g = g[p.key]
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=rtol, atol=1e-6,
                                       err_msg=jtu.keystr(path))
    assert tst["m"]["embed"]["table"].dtype == getattr(torch, moments)
    assert int(tst["step"]) == n_steps
    # decay: the per-layer norm scales are stacked (L, d) in the reference
    # and decayed; the final norm (d,) is not
    assert float(tp["final_norm"]["scale"][0]) != 1.0
    assert np.asarray(jp["final_norm"]["scale"]).ndim == 1


# ---------------------------------------------------------------------------
# The per-call residue matmul and its straight-through backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system,M", [("rns", 4), ("rns", 16), ("rns", 37),
                                      ("sdrns", 4), ("sdrns", 9)])
def test_dense_per_call_equals_prepared_and_reference(system, M):
    """The per-call forward of a float weight equals the prepared weight's
    bit for bit, and under ``sdrns`` (its matvec route at M <= 8, the
    matmul route above; a narrow weight, as the plain SD version is slow
    on a loaded CPU) the ``rns`` forward's.  Under ``rns`` it equals the
    reference's per-call forward bit for bit, and the straight-through
    gradients equal its custom VJP's."""
    rng = np.random.default_rng(M)
    K, N = (200, 72) if system == "rns" else (40, 16)
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    kw = dict(system=system, compute_dtype=torch.float32)
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = linear.dense({"w": wt}, xt, **kw)
    prep = residency.prepare_dense({"w": torch.from_numpy(w)},
                                   system=system)
    assert torch.equal(y.detach(), linear.dense(prep, torch.from_numpy(x),
                                                **kw))
    if system == "sdrns":
        assert torch.equal(y.detach(), linear.dense(
            {"w": torch.from_numpy(w)}, torch.from_numpy(x),
            **dict(kw, system="rns")))
        return
    jkw = dict(system=system, impl="ref", compute_dtype=jnp.float32)
    jy = jlinear.dense({"w": jnp.asarray(w)}, jnp.asarray(x), **jkw)
    g = rng.normal(size=jy.shape).astype(np.float32)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jlinear.dense(
        {"w": b}, a, **jkw) * g), argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=2e-4,
                               atol=2e-5)


def test_stacked_qmatmul_per_call_equals_prepared_and_reference():
    """The expert-stacked einsum on a float stack: bit for bit the prepared
    stack's output and the reference's; gradients the reference's (its
    einsum forms, a zero token row included)."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32)
    x = rng.normal(size=(3, 16, 40)).astype(np.float32)
    x[1, 3] = 0.0                       # an empty capacity slot
    sub = "ecd,edf->ecf"
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = linear.stacked_qmatmul(sub, xt, wt, system="rns")
    prep = residency.prepare_weight(torch.from_numpy(w), system="rns")
    assert torch.equal(y.detach(), linear.stacked_qmatmul(
        sub, torch.from_numpy(x), prep, system="rns"))
    g = rng.normal(size=y.shape).astype(np.float32)

    def f(a, b):
        return jlinear.stacked_qmatmul(sub, a, b, system="rns", impl="ref")

    jy = f(jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(f(a, b) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=2e-4,
                               atol=2e-5)


def test_dequantize_weight_matches_reference():
    w = np.random.default_rng(3).normal(size=(2, 24, 16)).astype(np.float32)
    got = residency.dequantize_weight(
        residency.prepare_weight(torch.from_numpy(w), system="rns"))
    want = jresidency.dequantize_weight(
        jresidency.prepare_weight(jnp.asarray(w), system="rns", bits=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="prepared"):
        residency.dequantize_weight({"w": torch.from_numpy(w)})


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _qwen3(system="rns", **kw):
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), **kw)
    return cfg, build_model(cfg, system=system, device="cpu")


def _tree(cfg):
    return from_jax_params(load_npz(os.path.join(
        CKPT_DIR, "ckpt_0000000002.npz")), cfg, "cpu")


def test_micro_batches_match_full_batch():
    """``n_micro=4`` gives the full batch's loss and step (the reference's
    limits), gradients summed in f32 and divided by 4."""
    cfg, model = _qwen3()
    batch = TokenPipeline(cfg.vocab, 16, 8, seed=2).batch_at(0)
    p0 = _tree(cfg)
    out = {}
    for n in (1, 4):
        st = make_train_step(model, OPT, n)
        out[n] = st(p0, optimizer.init_opt_state(p0, OPT), batch)
    np.testing.assert_allclose(float(out[1][2]["loss"]),
                               float(out[4][2]["loss"]), rtol=1e-5)
    for a, b in zip(jtu.tree_leaves(to_jax_params(out[1][0])),
                    jtu.tree_leaves(to_jax_params(out[4][0]))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_remat_step_equals_no_remat_bit_for_bit():
    """Recomputing each layer in the backward (``remat``) gives the loss and
    every gradient of the step that keeps its activations, bit for bit
    (the card's [train-small] holds ``sdrns`` against ``rns`` there)."""
    results = []
    for remat in (False, True):
        cfg, model = _qwen3("rns", remat=remat)
        batch = TokenPipeline(cfg.vocab, 8, 2, seed=4).batch_at(0)
        results.append(loss_and_grads(model, _tree(cfg), batch))
    (l0, c0), g0 = results[0]
    (l1, c1), g1 = results[1]
    assert torch.equal(l1, l0) and torch.equal(c1, c0)
    for a, b in zip(jtu.tree_leaves(to_jax_params(g1)),
                    jtu.tree_leaves(to_jax_params(g0))):
        np.testing.assert_array_equal(a, b)


def test_init_float_then_prepare_equals_prepared_init():
    """``init(seed, prepare=False)`` gives the float weights that
    ``init(seed)`` makes resident, in ``param_dtype``."""
    cfg, model = _qwen3()
    flat = model.init(0, prepare=False)
    assert isinstance(flat["layers"][0]["attn"]["wq"]["w"], torch.Tensor)
    a = residency.map_resident(model.prepare_params(flat), lambda t: t.planes)
    b = residency.map_resident(model.init(0), lambda t: t.planes)
    for x, y in zip(jtu.tree_leaves(a), jtu.tree_leaves(b)):
        assert torch.equal(x, y)
    grok = build_model(get_config("grok-1-314b").reduced(), device="cpu")
    assert grok.init(0)["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Checkpoints and restarts
# ---------------------------------------------------------------------------


def _template(cfg, model):
    params = model.init(0, prepare=False)
    return {"params": params,
            "opt_state": optimizer.init_opt_state(params, OPT)}


def _jtemplate():
    jm = jbuild_model(jget_config("qwen3-8b").reduced(), system="rns")
    params = jm.init(jax.random.PRNGKey(0))
    return {"params": params,
            "opt_state": jopt.init_opt_state(params, jopt.OptConfig())}


def test_committed_checkpoint_restores_both_ways(tmp_path):
    """The committed reduced checkpoint (40 leaves, step 2) restores into
    the port equal to the reference's restore; the port's save of it
    restores in the reference equal again, and byte for byte the same
    arrays under the same keys."""
    cfg, model = _qwen3()
    assert checkpoint.latest_step(CKPT_DIR) == 2
    ours = checkpoint.restore(CKPT_DIR, _template(cfg, model))
    ref = jckpt.restore(CKPT_DIR, _jtemplate())
    _assert_tree_equal(to_jax_params(ours), ref)
    assert ours["opt_state"]["step"].dtype == torch.int32
    checkpoint.save(str(tmp_path), 2, ours)
    back = jckpt.restore(str(tmp_path), _jtemplate())
    _assert_tree_equal(back, ref)
    with np.load(os.path.join(CKPT_DIR, "ckpt_0000000002.npz")) as a, \
            np.load(tmp_path / "ckpt_0000000002.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 40
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert json.load(open(tmp_path / "manifest.json")) == {
        "step": 2, "n_leaves": 40}


def test_bf16_leaves_round_trip_both_ways(tmp_path):
    """A bf16 leaf (grok's ``param_dtype``) is written as f32 and restores
    into a bf16 template in both packages; the reference's bf16 write
    restores here bit for bit."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    checkpoint.save(str(tmp_path / "ours"), 1, {"w": [x, x * 2]})
    tmpl = {"w": jnp.zeros((2, 3, 5), jnp.bfloat16)}
    back = jckpt.restore(str(tmp_path / "ours"), tmpl)
    np.testing.assert_array_equal(
        np.asarray(back["w"], np.float32),
        torch.stack([x, x * 2]).float().numpy())
    jckpt.save(str(tmp_path / "ref"), 1, {"w": back["w"]})
    ours = checkpoint.restore(str(tmp_path / "ref"), {
        "w": [torch.zeros(3, 5, dtype=torch.bfloat16)] * 2})
    assert ours["w"][0].dtype == torch.bfloat16
    assert torch.equal(ours["w"][1], x * 2)


def test_restore_refuses_kind_casts_and_misfits(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"a": torch.zeros(4, dtype=torch.int32),
                           "b": [torch.ones(2), torch.ones(2)]})
    ok = {"a": torch.zeros(4, dtype=torch.int64),
          "b": [torch.zeros(2), torch.zeros(2)]}
    got = checkpoint.restore(d, ok)
    assert got["a"].dtype == torch.int64 and got["b"][1].tolist() == [1, 1]
    with pytest.raises(ValueError, match="dtype-kind"):
        checkpoint.restore(d, dict(ok, a=torch.zeros(4)))
    with pytest.raises(ValueError, match="dtype-kind"):
        checkpoint.restore(d, dict(ok, b=[torch.zeros(2, dtype=torch.int8)]
                                   * 2))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, dict(ok, a=torch.zeros(5, dtype=torch.int32)))
    with pytest.raises(ValueError, match="layer stacks"):
        checkpoint.restore(d, dict(ok, b=[torch.zeros(2)] * 3))
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(d, dict(ok, c=torch.zeros(1)))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), ok)
    prepared = residency.prepare_weight(torch.ones(8, 4), system="rns")
    with pytest.raises(TypeError, match="residue-resident"):
        checkpoint.save(d, 2, {"w": prepared})


def test_retention_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        checkpoint.save(d, s, {"x": torch.full((2,), float(s))}, keep=3)
    assert checkpoint.all_steps(d) == [3, 4, 5]
    assert checkpoint.latest_step(d) == 5
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    assert json.load(open(tmp_path / "manifest.json"))["step"] == 5
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_failure_restart_is_bit_identical(tmp_path):
    """A run that fails before step 5 and restarts from its step-4
    checkpoint ends with the parameters and moments of an uninterrupted
    run, bit for bit, and the loss falls on the learnable stream."""
    cfg, model = _qwen3()
    pipe = TokenPipeline(cfg.vocab, 16, 4, seed=0)
    step = make_train_step(model, OPT, 2)

    def init_state():
        return _template(cfg, model)

    def run(d, failure_at=None):
        fcfg = FtConfig(ckpt_dir=str(d), total_steps=8, ckpt_every=2,
                        failure_at=failure_at, log_fn=lambda s: None,
                        heartbeat_path=str(tmp_path / "hb"))

        def once():
            try:
                return run_training(init_state=init_state, train_step=step,
                                    batch_at=pipe.batch_at, cfg=fcfg)
            finally:
                fcfg.failure_at = None

        return run_with_restarts(once, log_fn=lambda s: None)

    whole = run(tmp_path / "a")
    with pytest.raises(SimulatedFailure):
        run_training(init_state=init_state, train_step=step,
                     batch_at=pipe.batch_at,
                     cfg=FtConfig(ckpt_dir=str(tmp_path / "c"),
                                  total_steps=8, failure_at=0,
                                  log_fn=lambda s: None))
    restarted = run(tmp_path / "b", failure_at=5)
    assert len(restarted["history"]) == 4          # steps 4..7 after restart
    assert restarted["history"] == whole["history"][4:]
    _assert_tree_equal(to_jax_params({k: restarted[k] for k in (
        "params", "opt_state")}), to_jax_params({k: whole[k] for k in (
            "params", "opt_state")}))
    assert checkpoint.all_steps(str(tmp_path / "b")) == [4, 6, 8]
    assert open(tmp_path / "hb").read().startswith("7 ")
    assert whole["history"][-1] < whole["history"][0]


# ---------------------------------------------------------------------------
# Entry points and the unprepared serving path
# ---------------------------------------------------------------------------


def test_train_cli_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "qwen3-8b", "--reduced", "--system", "rns",
            "--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "16",
            "--micro", "2", "--ckpt-every", "2", "--failure-at", "3",
            "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "injected failure before step 3" in out
    assert "restored checkpoint at step 2" in out and "[done]" in out
    assert train.main(argv) == 0
    assert "nothing to do" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(["--arch", "whisper-small", "--reduced", "--device",
                    "cpu", "--ckpt-dir", str(tmp_path / "w")])


def test_serve_cli_no_prepare_gives_the_prepared_tokens(capsys):
    from repro_torch.launch import serve

    outs = []
    for extra in ([], ["--no-prepare"]):
        assert serve.main(["--arch", "qwen3-8b", "--reduced", "--system",
                           "rns", "--kv-format", "rns8", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4", *extra]) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.strip().startswith("seq")])
    assert outs[0] == outs[1] and len(outs[0]) == 2


@pytest.mark.parametrize("arch,system,kw", [
    ("qwen3-8b", "rns", dict(kv_format="rns8")),
    ("qwen3-8b", "sdrns", dict(paged=False)),
    ("moonshot-v1-16b-a3b", "rns", dict(kv_format="rns8"))])
def test_engine_unprepared_equals_prepared(arch, system, kw):
    """``ServingEngine(prepare=False)`` serves float weights through the
    per-call path: the prepared engine's prefill logits and tokens, bit for
    bit (the reference's ``tests/test_residency.py`` pins the tokens)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, system=system, device="cpu")
    params = model.init(0, prepare=False)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    res = []
    for prepare in (True, False):
        eng = ServingEngine(model, params, batch=2, s_max=16, page_size=8,
                            device="cpu", prepare=prepare, **kw)
        assert eng.prepared == prepare
        res.append(eng.generate({"tokens": prompts}, max_new=4))
    np.testing.assert_array_equal(res[0].prefill_logits,
                                  res[1].prefill_logits)
    np.testing.assert_array_equal(res[0].tokens, res[1].tokens)
