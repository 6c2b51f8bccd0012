"""Sharded checkpoints: a train state of blocks on (2, 2) saved through
``ft.run_training`` (gathered whole, in the reference's layout) restores
onto another mesh, (1, 2), and onto one process, and the next step there
equals the reference's uninterrupted two steps within the limits of
``test_torch_mesh_train.py`` (reduced qwen3-8b under ``rns``, SP on)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.models.api import build_model as jbuild_model
from repro.train.loop import make_train_step as jmake_train_step
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint
from repro_torch.train.loop import TrainSharding, make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state

import torch_mesh
from test_torch_mesh_train import N_MICRO, OPT, close_tree, jtiny_cfg
from torch_threads import one_thread  # noqa: F401

ARCH, SYSTEM = "qwen3-8b", "rns"


def _reference(jcfg):
    """The reference's two uninterrupted steps on the pipeline's batches 0
    and 1: the second step's loss and the state after it."""
    jm = jbuild_model(jcfg, system=SYSTEM, rns_impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    jocfg = JOptConfig(**OPT, moment_dtype=jcfg.opt_state_dtype)
    step = jax.jit(jmake_train_step(jm, jocfg, N_MICRO))
    pipe = TokenPipeline(jcfg.vocab, 8, 4, seed=1)
    st = jinit_opt(jp, jocfg)
    for i in range(2):
        jp, st, met = step(jp, st, {k: jnp.asarray(v) for k, v in
                                    pipe.batch_at(i).items()})
    return float(met["loss"]), jp, st


def _check(loss, state, ref):
    rloss, rp, rst = ref
    np.testing.assert_allclose(loss, rloss, rtol=1e-5)
    close_tree(to_jax_params(state["params"]), rp, "param")
    close_tree(to_jax_params(state["opt_state"]["m"]), rst["m"], "m")
    close_tree(to_jax_params(state["opt_state"]["v"]), rst["v"], "v")
    assert int(state["opt_state"]["step"]) == 2


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    cfg, jcfg = torch_mesh.tiny_cfg(ARCH), jtiny_cfg(ARCH)
    tree = jtu.tree_map(np.asarray, jbuild_model(
        jcfg, system="bns").init(jax.random.PRNGKey(0)))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    run = torch_mesh.RankRun(torch_mesh.ckpt_body, 4,
                             tmp_path_factory.mktemp("mesh_ckpt"), cfg,
                             SYSTEM, tree, ckpt, N_MICRO, OPT)
    ref = _reference(jcfg)
    return run.results(), ref, cfg, tree, ckpt


def test_restores_onto_another_mesh(ckpt_run):
    ranks, ref, *_ = ckpt_run
    for r in range(2):
        got = ranks[r]["load"]
        assert len(got["history"]) == 1          # step 1 alone, restored
        _check(got["history"][0], got["state"], ref)
    assert "load" not in ranks[2] and "load" not in ranks[3]


def test_restores_onto_one_process(ckpt_run):
    ranks, ref, cfg, tree, ckpt = ckpt_run
    assert checkpoint.all_steps(ckpt) == [1, 2]
    model = build_model(cfg, system=SYSTEM, device="cpu")
    ocfg = OptConfig(**OPT, moment_dtype=cfg.opt_state_dtype)
    params = from_jax_params(tree, cfg, "cpu")
    state = checkpoint.restore(ckpt, {"params": params, "opt_state":
                                      init_opt_state(params, ocfg)}, 1)
    # the saved state is the (2, 2) ranks' gathered state after step 0
    saved = ranks[0]["save"]["state"]
    close_tree(to_jax_params(state["params"]),
               jtu.tree_map(np.asarray, to_jax_params(saved["params"])),
               "restored param")
    p, st, met = make_train_step(model, ocfg, N_MICRO)(
        state["params"], state["opt_state"],
        TokenPipeline(cfg.vocab, 8, 4, seed=1).batch_at(1))
    _check(float(met["loss"]), {"params": p, "opt_state": st}, ref)


def test_sharded_step_refuses_whole_params(tmp_path):
    """A whole tree handed to a sharded step raises rather than run
    replicated (checked before any collective)."""
    from repro_torch.parallel.sharding import AbstractMesh, ShardCtx

    cfg = torch_mesh.tiny_cfg(ARCH)
    model = build_model(cfg, system=SYSTEM, device="cpu")
    params = model.init(0, prepare=False)
    ctx = ShardCtx(AbstractMesh((2, 2), ("data", "model")))
    sh = TrainSharding.of(params, ctx)
    ocfg = OptConfig(**OPT)
    with pytest.raises(ValueError, match="blocks"):
        make_train_step(model, ocfg, 1, sh)(
            params, init_opt_state(params, ocfg),
            TokenPipeline(cfg.vocab, 8, 4, seed=1).batch_at(0))
