"""The sharded train step (``train/loop.py`` with a ``TrainSharding``) on
gloo ranks against the reference's single-device ``make_train_step``.

Reduced qwen3-8b (``torch_mesh.tiny_cfg``: one layer, d_model 16), B 4 x
8 tokens in 2 micro-batches, under ``rns`` and ``bns`` on the meshes (1, 2)
with and without ``seq_shard``, (2, 1), and (2, 2) with ``seq_shard``
(``sdrns`` on (1, 2) is ``test_torch_mesh_train_sd.py``, whose reference
takes most of a minute alone).  The weights are the reference's
``init(PRNGKey(0))``, carried by ``convert.from_jax_params`` as
``tests/torch_train_parity.py`` carries them; every rank places them on
its blocks, runs the step, and gathers the gradients and the state after
one AdamW step whole.  Limits: the loss and the cross entropy within 1e-5
relative, the global gradient norm within 1e-5, and every gradient,
parameter, ``m`` and ``v`` within the reference's own ``rtol=2e-4,
atol=2e-5``.  On the meshes with no data axis the forward's logits under
``rns`` equal the port's one-process logits bit for bit: every residue
product of the column and row plans is exact.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.train.loop import make_train_step as jmake_train_step
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import transformer
from repro_torch.models.api import build_model

import torch_mesh
from torch_threads import one_thread  # noqa: F401

ARCH = "qwen3-8b"
B, S, N_MICRO = 4, 8, 2
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
MESHES = {"tp": ((1, 2), False), "tp-sp": ((1, 2), True),
          "dp": ((2, 1), False), "dp-tp-sp": ((2, 2), True)}
CASES = [(s, m) for s in ("rns", "bns") for m in MESHES]
RTOL, ATOL = 2e-4, 2e-5


def jtiny_cfg(arch: str):
    """The reference's twin of ``torch_mesh.tiny_cfg``."""
    return dataclasses.replace(jget_config(arch).reduced(), n_layers=1,
                               d_model=16, n_heads=2, n_kv=1, d_ff=32,
                               vocab=64, head_dim=8, compute_dtype="float32")


def reference_step(jcfg, system: str, batch: dict, n_micro: int,
                   steps: int = 2) -> dict:
    """The reference's single-device step of config ``jcfg``: its metrics
    over ``steps`` steps, the first step's gradients (its micro-batch
    mean, as its step takes it) and the state after the first step."""
    jm = jbuild_model(jcfg, system=system, rns_impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    jocfg = JOptConfig(**OPT, moment_dtype=jcfg.opt_state_dtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    micro = [{k: v.reshape(n_micro, -1, *v.shape[1:])[i]
              for k, v in jb.items()} for i in range(n_micro)]
    gs = [grad(jp, mb) for mb in micro]
    jg = jtu.tree_map(lambda *a: sum(a) / n_micro, *gs)
    step = jax.jit(jmake_train_step(jm, jocfg, n_micro))
    p, st = jp, jinit_opt(jp, jocfg)
    mets, first = [], None
    for _ in range(steps):
        p, st, met = step(p, st, jb)
        mets.append({k: float(v) for k, v in met.items()})
        first = first or (p, st)
    return {"tree": jtu.tree_map(np.asarray, jp), "grads": jg,
            "params": first[0], "m": first[1]["m"], "v": first[1]["v"],
            "metrics": mets}


def close_tree(got, want, what: str) -> int:
    flat = jtu.tree_flatten_with_path(want)[0]
    for path, w in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=RTOL,
                                   atol=ATOL,
                                   err_msg=f"{what} {jtu.keystr(path)}")
    return len(flat)


def check_case(got: dict, ref: dict) -> None:
    """The limits of the module docstring for one rank's result."""
    met = ref["metrics"][0]
    np.testing.assert_allclose(got["loss"], met["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["ce"], met["ce"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], met["grad_norm"],
                               rtol=1e-5)
    n = close_tree(to_jax_params(got["grads"]), ref["grads"], "grad")
    assert n == len(jtu.tree_leaves(ref["tree"]))
    st = got["state"]
    close_tree(to_jax_params(st["params"]), ref["params"], "param")
    close_tree(to_jax_params(st["opt_state"]["m"]), ref["m"], "m")
    close_tree(to_jax_params(st["opt_state"]["v"]), ref["v"], "v")
    for i, loss in enumerate(got["losses"]):
        np.testing.assert_allclose(loss, ref["metrics"][i]["loss"],
                                   rtol=1e-5)


def run_cases(tmp_path, cases: list[tuple[str, str]]):
    """The rank results of ``(system, mesh)`` cases, the reference's step
    per system and the port's one-process logits under rns / sdrns."""
    cfg = torch_mesh.tiny_cfg(ARCH)
    batch = TokenPipeline(cfg.vocab, S, B, seed=1).batch_at(0)
    tree = jtu.tree_map(np.asarray, jbuild_model(
        jtiny_cfg(ARCH), system="bns").init(jax.random.PRNGKey(0)))
    # the (2, 2) case recomputes its layer in the backward (remat, which
    # the reference's numbers do not depend on) and runs two steps
    rank_cases = [(f"{s}/{m}", dataclasses.replace(cfg, remat=m == "dp-tp-sp"),
                   s, *MESHES[m], tree, batch, 2 if m == "dp-tp-sp" else 1)
                  for s, m in cases]
    run = torch_mesh.RankRun(torch_mesh.train_body, 4, tmp_path, rank_cases,
                             N_MICRO, OPT)
    systems = sorted({s for s, _ in cases})
    refs = {s: reference_step(jtiny_cfg(ARCH), s, batch, N_MICRO)
            for s in systems}
    ranks = run.results()
    one = {}
    for system in systems:
        model = build_model(cfg, system=system, device="cpu")
        with torch.no_grad():
            one[system] = transformer.lm_forward(
                from_jax_params(tree, cfg, "cpu"), cfg,
                torch.as_tensor(batch["tokens"]).long(),
                dense_kw={"system": system,
                          "compute_dtype": torch.float32})[0]
    return ranks, refs, one


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("mesh_train"), CASES)


@pytest.mark.parametrize("system,mesh", CASES)
def test_sharded_step_matches_reference(train_run, system, mesh):
    ranks, refs, _ = train_run
    shape = MESHES[mesh][0]
    for r in range(shape[0] * shape[1]):
        check_case(ranks[r][f"{system}/{mesh}"], refs[system])


@pytest.mark.parametrize("system,mesh", [("rns", "tp"), ("rns", "tp-sp")])
def test_tp_logits_bit_exact(train_run, system, mesh):
    ranks, _, one = train_run
    for r in range(2):
        got = ranks[r][f"{system}/{mesh}"]["logits"]
        assert torch.equal(got, one[system]), (system, mesh, r)


@pytest.mark.parametrize("mesh", ["dp", "dp-tp-sp"])
def test_dp_ranks_hold_their_rows(train_run, mesh):
    """Each dp rank's rows are its block of every micro-batch; its
    logits are the one-process logits of those rows (within the model
    parity bound: the row plan sums the same integers, the f32 products
    of the dp ranks' rows run apart)."""
    ranks, _, one = train_run
    shape = MESHES[mesh][0]
    for r in range(shape[0] * shape[1]):
        got = ranks[r][f"rns/{mesh}"]
        d = r // shape[1]
        rows = [m * (B // N_MICRO) + d * (B // N_MICRO // shape[0]) + i
                for m in range(N_MICRO)
                for i in range(B // N_MICRO // shape[0])]
        tok = torch.as_tensor(
            TokenPipeline(64, S, B, seed=1).batch_at(0)["tokens"]).long()
        assert torch.equal(got["rows"], tok[rows])
        # the forward ran on one micro-batch's worth of rows at a time
        np.testing.assert_allclose(got["logits"].numpy(),
                                   one["rns"][rows].numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_blocks_split_the_state(train_run):
    """On (2, 2) a rank holds about a quarter of the parameters (the
    vectors, replicated, make up the rest)."""
    ranks, refs, _ = train_run
    whole = sum(np.asarray(x).nbytes
                for x in jtu.tree_leaves(refs["rns"]["tree"]))
    got = [ranks[r]["rns/dp-tp-sp"]["block_bytes"] for r in range(4)]
    assert all(whole / 4 <= b < whole / 3 for b in got), (got, whole)
    moved = ranks[0]["rns/dp-tp-sp"]["moved"]
    assert set(moved) == {"all_gather", "all_reduce", "reduce_scatter"}
