"""The sharded train step of the moe and ssm families on (2, 2) against the
reference's single-device ``make_train_step``, with the limits of
``test_torch_mesh_train.py``.

Reduced moonshot (``torch_mesh.tiny_cfg``: 4 experts, top 2) runs its
expert stacks split on E over the model axis (EP: E divides it), under
``rns`` with ``seq_shard`` and under ``bns`` without; its capacity factor
is cut to 1.0 so that slots drop.  Its batch (8 x 8 tokens, 2
micro-batches) starts each of its first two rows with one repeated token:
every position of those rows routes to the same two experts, overflowing
them.  The reference routes each micro-batch whole (capacity from its 32
tokens, positions in its token order), and so must the port, whose dp
ranks hold 16 tokens each: a capacity from the local count, or positions
that ignore the lower rank's slots, keeps other tokens (the test checks
that this batch tells them apart) and moves the loss.  Reduced mamba2 (the
ssm family, which takes no SP) trains under ``rns``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.models.api import build_model as jbuild_model
from repro_torch.convert import from_jax_params
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import moe as moe_mod
from repro_torch.models.api import build_model

import torch_mesh
from test_torch_mesh_train import (N_MICRO, OPT, check_case, jtiny_cfg,
                                   reference_step)
from torch_threads import one_thread  # noqa: F401

MOE, SSM = "moonshot-v1-16b-a3b", "mamba2-780m"
B, S, CF = 8, 8, 1.0
CASES = [(MOE, "rns", True), (MOE, "bns", False), (SSM, "rns", True)]


def _cfgs(arch):
    cfg, jcfg = torch_mesh.tiny_cfg(arch), jtiny_cfg(arch)
    if arch == MOE:
        cfg = dataclasses.replace(cfg, moe_cf=CF)
        jcfg = dataclasses.replace(jcfg, moe_cf=CF)
    return cfg, jcfg


def _batch(vocab: int) -> dict:
    b = TokenPipeline(vocab, S, B, seed=3).batch_at(0)
    b["tokens"][:2] = 5           # micro-batch 0: one row on each dp rank
    return b


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    cases, refs, trees = [], {}, {}
    for arch, system, sp in CASES:
        cfg, jcfg = _cfgs(arch)
        if arch not in trees:
            trees[arch] = jtu.tree_map(np.asarray, jbuild_model(
                jcfg, system="bns").init(jax.random.PRNGKey(0)))
        cases.append((f"{arch}/{system}", cfg, system, (2, 2), sp,
                      trees[arch], _batch(cfg.vocab), 2))
    run = torch_mesh.RankRun(torch_mesh.train_body, 4,
                             tmp_path_factory.mktemp("mesh_train_moe"),
                             cases, N_MICRO, OPT)
    for arch, system, _ in CASES:
        refs[(arch, system)] = reference_step(_cfgs(arch)[1], system,
                                              _batch(_cfgs(arch)[0].vocab),
                                              N_MICRO)
    return run.results(), refs, trees


@pytest.mark.parametrize("arch,system,sp", CASES)
def test_sharded_step_matches_reference(moe_run, arch, system, sp):
    ranks, refs, _ = moe_run
    for r in range(4):
        check_case(ranks[r][f"{arch}/{system}"], refs[(arch, system)])


def test_batch_tells_local_routing_apart(moe_run):
    """On this batch, routing each dp rank's tokens alone (a capacity from
    16 tokens, positions from 0 on each rank) keeps other slots than
    routing the micro-batch whole, as the reference does: the batch would
    catch a local capacity or missing offsets."""
    _, _, trees = moe_run
    cfg, _ = _cfgs(MOE)
    model = build_model(cfg, system="bns", device="cpu")
    seen, place = [], moe_mod.place

    def record(idx, E, C, rows=None):
        seen.append((idx.clone(), E, C))
        return place(idx, E, C, rows)

    batch = _batch(cfg.vocab)
    mb = {k: v[: B // N_MICRO] for k, v in batch.items()}
    moe_mod.place = record
    try:
        with torch.no_grad():
            model.loss(from_jax_params(trees[MOE], cfg, "cpu"), mb)
    finally:
        moe_mod.place = place
    (idx, E, C), = seen
    T = idx.shape[0]
    keep_global = place(idx, E, C)[2]
    C_loc = moe_mod.moe_capacity(T // 2, E, cfg.top_k, CF)
    halves = [place(idx[: T // 2], E, C_loc)[2],
              place(idx[T // 2:], E, C_loc)[2]]
    assert C_loc < C
    assert not torch.equal(keep_global, torch.cat(halves))
    assert not keep_global.all()          # slots do drop
    unoffset = [place(h, E, C)[2] for h in (idx[: T // 2], idx[T // 2:])]
    assert not torch.equal(keep_global, torch.cat(unoffset))


def test_expert_stacks_split_on_experts(moe_run):
    """EP: each rank holds a quarter of each expert stack (E over the
    model axis, d_model over the data axis)."""
    ranks, refs, _ = moe_run
    whole = sum(np.asarray(x).nbytes
                for x in jtu.tree_leaves(refs[(MOE, "rns")]["tree"]))
    for r in range(4):
        got = ranks[r][f"{MOE}/rns"]["block_bytes"]
        assert whole / 4 <= got < whole / 3, (got, whole)
