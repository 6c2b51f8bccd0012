"""Gloo process groups for the port's mesh tests, and the rank bodies they
run.

:class:`RankRun` spawns ``world`` processes (start method ``spawn``), each
joining a ``gloo`` group through a ``file://`` init under the test's
``tmp_path`` (a fixed ``MASTER_PORT`` would collide between test workers),
with one torch thread a rank.  Each rank runs ``body(rank, *args)`` and
saves what it returns; the test process reads the list, rank by rank.  The bodies
import only ``torch`` and ``repro_torch``: the reference's outputs are
computed in the test process and compared there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

__all__ = ["RankRun", "dense_case_keys", "dense_inputs", "random_tree",
           "tiny_cfg", "train_body", "coll_grad_body", "COLL_GROUPS",
           "ckpt_body"]


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _entry(rank, world, init, out_dir, body, args):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_group

    import torch.distributed as dist

    backend = init_process_group(backend="gloo", init_method=f"file://{init}",
                                 rank=rank, world_size=world)
    assert backend == "gloo"
    try:
        out = body(rank, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class RankRun:
    """``body(rank, *args)`` started on ``world`` gloo ranks; the test
    process computes the reference's side meanwhile and then reads
    :meth:`results`."""

    def __init__(self, body, world: int, tmp_path, *args):
        import torch.multiprocessing as mp

        self.world, self.out_dir = world, str(tmp_path)
        init = os.path.join(self.out_dir, "pg_init")
        with _env(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"):
            self.pc = mp.start_processes(
                _entry, args=(world, init, self.out_dir, body, args),
                nprocs=world, join=False, start_method="spawn")

    def results(self, timeout: float = 240.0) -> list:
        deadline = time.monotonic() + timeout
        while not self.pc.join(timeout=2):
            if time.monotonic() > deadline:
                for p in self.pc.processes:
                    p.kill()
                raise TimeoutError(f"{self.world} ranks ran past "
                                   f"{timeout} s")
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


# ---------------------------------------------------------------------------
# Shared inputs: the dense cases of the reference's sharded-residency test
# (a (24, 16) weight, activations of M 2 and 16: the matvec and the matmul
# routes), made with numpy.
# ---------------------------------------------------------------------------


def dense_case_keys(cases):
    return [(system, mset, M) for system, mset in cases for M in (2, 16)]


def dense_inputs(cases, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for key in dense_case_keys(cases):
        w = (rng.normal(size=(24, 16)) * (2.0 / 40) ** 0.5).astype(np.float32)
        x = rng.normal(size=(key[2], 24)).astype(np.float32)
        out[key] = (w, x)
    return out


def random_tree(shapes, seed: int):
    """Random f32 values (scale 0.3) over a tree of shapes (dicts of
    objects with ``.shape``), made with numpy."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        return (0.3 * rng.normal(size=node.shape)).astype(np.float32)

    return fill(shapes)


def tiny_cfg(arch: str = "yi-6b"):
    """The reference test's model: one layer, d_model 16, 2 heads on 1 KV
    head (head_dim 8), d_ff 32, vocab 64, f32 compute."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), n_layers=1,
                               d_model=16, n_heads=2, n_kv=1, d_ff=32,
                               vocab=64, head_dim=8, compute_dtype="float32")


def _dense(prep, x, system, mset):
    from repro_torch.models import linear

    return linear.dense(prep, torch.as_tensor(x), system=system, mset=mset,
                        compute_dtype=torch.float32)


def _decode(model, params):
    tok = torch.zeros((2, 1), dtype=torch.long)
    logits, _ = model.decode(params, tok, model.init_cache(2, 8), 3)
    return logits


def _rank_info(mesh):
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


# ---------------------------------------------------------------------------
# (2, 2): the column layout and the C-split layout of the default mesh.
# ---------------------------------------------------------------------------


def col_body(rank, inputs, w_place, w_crt, yi_tree):
    from repro_torch.core import moduli
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.numerics import api as nx
    from repro_torch.numerics import runners
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import shard_ctx, shard_params
    from repro_torch.quant import residency

    mesh = make_test_mesh((2, 2))
    ctx, ctx_c = make_ctx(mesh), make_ctx(mesh, channel_shard=True)
    out = {"coord": _rank_info(mesh), "dense": {}, "specs": {}, "row": {}}
    for key, (w, x) in inputs.items():
        system, mname, M = key
        mset = getattr(moduli, mname)
        prep = residency.prepare_dense({"w": torch.as_tensor(w)},
                                       system=system, bits=4, mset=mset)
        out["dense"][("base",) + key] = _dense(prep, x, system, mset)
        for name, c in (("tp", ctx), ("cshard", ctx_c)):
            with shard_ctx(c):
                prep_sh = shard_params({"wq": prep}, c)["wq"]
                out["dense"][(name,) + key] = _dense(prep_sh, x, system,
                                                     mset)
            out["specs"][(name,) + key] = tuple(prep_sh["w"].sharding.planes)
        # a row-parallel weight (K over the model axis) on the row plan
        with shard_ctx(ctx):
            prep_row = shard_params({"wo": prep}, ctx)["wo"]
            t_row = prep_row["w"]
            plan = runners.weight_plan(t_row, M)
            collectives.reset_moved_bytes()
            block = runners.plan_planes(t_row, plan)
            out["row"][key] = dict(
                plan=plan[0], spec=tuple(t_row.sharding.planes),
                block=tuple(block.shape), local=tuple(t_row.planes.shape),
                local_bytes=t_row.planes.nbytes,
                moved=collectives.moved_bytes(),
                y=_dense(prep_row, x, system, mset))

    # prepare under a context keeps this rank's block
    with shard_ctx(ctx):
        t_sh = residency.prepare_weight(torch.as_tensor(w_place),
                                        system="sdrns", bits=4)
    out["place"] = dict(planes_spec=tuple(t_sh.sharding.planes),
                        scale_spec=tuple(t_sh.sharding.scale),
                        planes=t_sh.planes, scale=t_sh.scale,
                        whole=t_sh.unsharded().planes)

    # the C-split layout round-trips encode -> decode (CRT40, C = 6)
    t_ref = residency.prepare_weight(torch.as_tensor(w_crt), system="rns",
                                     bits=4, mset=moduli.CRT40)
    with shard_ctx(ctx_c):
        t_csp = residency.prepare_weight(torch.as_tensor(w_crt),
                                         system="rns", bits=4,
                                         mset=moduli.CRT40)
    out["crt40"] = dict(spec=tuple(t_csp.sharding.planes),
                        local_c=t_csp.planes.shape[0],
                        dec_sh=nx.decode(t_csp), dec=nx.decode(t_ref))

    # the whole decode step of a prepared tree on the column layout
    cfg = tiny_cfg()
    model = build_model(cfg, system="sdrns", device="cpu")
    raw = from_jax_params(yi_tree, cfg, "cpu")
    logits_1 = _decode(model, model.prepare_params(raw))
    plan, tags = runners.weight_plan, {}

    def tagged(t, M):
        p = plan(t, M)
        tags[p[0]] = tags.get(p[0], 0) + 1
        return p

    with shard_ctx(ctx):
        prep_mesh = model.prepare_params(raw)
        wq = prep_mesh["layers"][0]["attn"]["wq"]["w"]
        runners.weight_plan = tagged
        try:
            logits_mesh = _decode(model, prep_mesh)
        finally:
            runners.weight_plan = plan
    out["model"] = dict(logits_1=logits_1, logits_mesh=logits_mesh,
                        wq_spec=tuple(wq.sharding.planes),
                        wq_planes=wq.planes.nbytes,
                        wq_whole_planes=wq.unsharded().planes.nbytes,
                        tags=tags)
    return out


# ---------------------------------------------------------------------------
# (2, 3) and (1, 5): the channel split with its partial-CRT all-reduce.
# ---------------------------------------------------------------------------


def chan_body(rank, inputs, w_r, x_r, qa, wst, yi_tree):
    from repro_torch.core import moduli
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.numerics import api as nx
    from repro_torch.numerics import runners
    from repro_torch.parallel.sharding import shard_ctx, shard_params
    from repro_torch.quant import residency

    mesh23 = make_test_mesh((2, 3))
    mesh15 = make_test_mesh((1, 5), ranks=range(5))
    ctx23 = make_ctx(mesh23, channel_shard=True)
    out = {"coord": _rank_info(mesh23), "dense": {}, "plans": {}}
    for key, (w, x) in inputs.items():
        system, mname, M = key
        mset = getattr(moduli, mname)
        prep = residency.prepare_dense({"w": torch.as_tensor(w)},
                                       system=system, bits=4, mset=mset)
        out["dense"][("base",) + key] = _dense(prep, x, system, mset)
        with shard_ctx(ctx23):
            out["plans"][key] = runners.tp_shard_plan(M, 16, mset=mset)[0]
            prep_sh = shard_params({"wq": prep}, ctx23)["wq"]
            out["dense"][("chan",) + key] = _dense(prep_sh, x, system, mset)
        out["local_channels"] = prep_sh["w"].planes.shape[0]

    # the stacked einsum rides the channel plan (B1's stack mode)
    t_st = residency.prepare_weight(torch.as_tensor(wst), system="rns",
                                    bits=4)
    qa_t = torch.as_tensor(qa)
    y_st = nx.einsum("emk,ekn->emn", qa_t, t_st)
    with shard_ctx(ctx23):
        t_st_sh = residency.prepare_weight(torch.as_tensor(wst),
                                           system="rns", bits=4)
        y_st_sh = nx.einsum("emk,ekn->emn", qa_t, t_st_sh)
    out["einsum"] = dict(y=y_st, y_sh=y_st_sh,
                         spec=tuple(t_st_sh.sharding.planes))

    # the whole decode step under channel_shard (rns on P21)
    cfg = tiny_cfg()
    model = build_model(cfg, system="rns", device="cpu")
    raw = from_jax_params(yi_tree, cfg, "cpu")
    logits_1 = _decode(model, model.prepare_params(raw))
    with shard_ctx(ctx23):
        logits_c = _decode(model, model.prepare_params(raw))
    out["model"] = dict(logits_1=logits_1, logits_c=logits_c)

    if rank >= 5:
        return out
    # P21R2 on (1, 5): one channel a rank, the witnesses (global channels
    # 3 and 4) on ranks 3 and 4, apart from every information channel
    ctx15 = make_ctx(mesh15, channel_shard=True)
    P21R2 = moduli.P21R2
    prep_r = residency.prepare_dense({"w": torch.as_tensor(w_r)},
                                     system="rns", bits=4, mset=P21R2)
    y_base = _dense(prep_r, x_r, "rns", P21R2)
    with shard_ctx(ctx15):
        plan = runners.tp_shard_plan(2, 16, mset=P21R2)[0]
        prep_r_sh = shard_params({"wq": prep_r}, ctx15)["wq"]
        y_sh = _dense(prep_r_sh, x_r, "rns", P21R2)
        t_r = prep_r_sh["w"]
        planes = t_r.planes.clone()
        if rank == 0:                      # information channel 0
            planes[0, 3, 5] += 7
        t_bad = t_r._with_planes(planes)
        y_bad = _dense(dict(prep_r_sh, w=t_bad), x_r, "rns", P21R2)
        bad_whole = t_bad.unsharded().planes
        fixed_sh, det_s, cor_s = nx.scrub(t_bad)
    fixed_1, det_1, cor_1 = nx.scrub(prep_r["w"]._with_planes(bad_whole))
    out["p21r2"] = dict(plan=plan, y_base=y_base, y_sh=y_sh, y_bad=y_bad,
                        bad=bad_whole,
                        local_c=t_r.planes.shape[0],
                        spec=tuple(t_r.sharding.planes),
                        counts_sh=(det_s, cor_s), counts_1=(det_1, cor_1),
                        fixed_sh=fixed_sh.unsharded().planes,
                        fixed_local=fixed_sh.planes,
                        fixed_1=fixed_1.planes, clean=prep_r["w"].planes)
    return out


# ---------------------------------------------------------------------------
# Compression and the pipeline on 2 (ranks 0-1) and 4 ranks.
# ---------------------------------------------------------------------------


def compression_body(rank, grads_by_rank, err_by_rank, stage_w, xs,
                     reinject):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.parallel.compression import (init_error_state,
                                                  make_compressed_mean)
    from repro_torch.parallel.pipeline import pipeline_apply

    def tensors(tree):
        return {k: torch.as_tensor(v) for k, v in tree.items()}

    def stage_fn(w, h):
        return torch.tanh(h @ w) + h

    meshes = {n: make_test_mesh((n,), ("data",), ranks=range(n))
              for n in (4, 2, 1)}
    out = {"production": [(tuple(m.shape), tuple(m.mesh_dim_names)) for m in
                          (make_production_mesh(),
                           make_production_mesh(channel=2))]}
    for n, mesh in meshes.items():
        if rank >= n:
            continue
        fn = make_compressed_mean(mesh, ("data",))
        g = tensors(grads_by_rank[n][rank])
        err = (init_error_state(g) if err_by_rank is None or n == 1
               else tensors(err_by_rank[n][rank]))
        out[("mean", n)], out[("err", n)] = fn(g, err)
        out[("pipe", n)] = pipeline_apply(
            stage_fn, torch.as_tensor(stage_w[n]), torch.as_tensor(xs),
            mesh=mesh, axis="data")
        if n > 1:
            try:
                pipeline_apply(stage_fn, torch.as_tensor(stage_w[n]),
                               torch.as_tensor(xs[: n - 1]), mesh=mesh,
                               axis="data")
                out[("short", n)] = None
            except ValueError as e:
                out[("short", n)] = str(e)
        if n == 1:
            g2, e2 = reinject
            out["reinject"] = fn(tensors(g2), tensors(e2))[0]["w"]
    return out


# ---------------------------------------------------------------------------
# On the card: ranks that share it (gloo), one full-width qwen3 projection.
# ---------------------------------------------------------------------------


def card_plan_body(rank, n, layout, shapes):
    """The column, row or channel plan of each ``(K, N, M)`` projection on
    the card, against the single-device product (one B1 launch)."""
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.numerics import api as nx
    from repro_torch.parallel.sharding import (shard_ctx,
                                               shard_residue_tensor)
    from repro_torch.quant import residency

    mesh = make_test_mesh((1, n))
    ctx = make_ctx(mesh, channel_shard=layout == "chan")
    out = {}
    for K, N, M in shapes:
        gen = torch.Generator(device="cuda").manual_seed(K + N + M)
        w = torch.randn(K, N, generator=gen, device="cuda")
        qx = torch.randint(-7, 8, (M, K), generator=gen, device="cuda",
                           dtype=torch.int32)
        t = residency.prepare_weight(w, system="rns", bits=4)
        kernels.reset_launch_counts()
        one = nx.matmul(qx, t)
        n_one = kernels.launch_counts()["rns_matmul"]
        with shard_ctx(ctx):
            ts = shard_residue_tensor(
                t, ["tp", "dp"] if layout == "row" else ["dp", "tp"], ctx)
            kernels.reset_launch_counts()
            y = nx.matmul(qx, ts)
            n_mesh = kernels.launch_counts()["rns_matmul"]
        out[(K, N, M)] = dict(equal=bool(torch.equal(one, y)),
                              launches=(n_one, n_mesh),
                              block=tuple(ts.planes.shape))
    return out


# ---------------------------------------------------------------------------
# The sharded train step: each case on its own sub-mesh of the first ranks.
# ---------------------------------------------------------------------------


def train_body(rank, cases, n_micro, opt_kw):
    """Per case ``(label, cfg, system, mesh shape, seq_shard, tree, batch,
    steps)``: the sharded step from the whole tree (numpy, the reference's
    layout) on the mesh, ``steps`` AdamW steps; returns per case the
    metrics of each step, the first step's gradients and the state after
    the first step gathered whole, and the forward's logits on this rank's
    rows.  A rank outside a case's mesh returns nothing for it."""
    import dataclasses as dc

    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import shard_ctx
    from repro_torch.train import loop
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             init_opt_state)

    out = {}
    for label, cfg, system, shape, seq_shard, tree, batch, steps in cases:
        n = shape[0] * shape[1]
        mesh = make_test_mesh(shape, ranks=range(n))
        if rank >= n:
            continue
        ctx = make_ctx(mesh, seq_shard=seq_shard)
        model = build_model(cfg, system=system, device="cpu")
        params = from_jax_params(tree, cfg, "cpu")
        ocfg = OptConfig(**opt_kw, moment_dtype=cfg.opt_state_dtype)
        sh = loop.TrainSharding.of(params, ctx)
        state = sh.place_state({"params": params,
                                "opt_state": init_opt_state(params, ocfg)})
        p, st = state["params"], state["opt_state"]
        collectives.reset_moved_bytes()
        (loss, ce), g = loop.make_grad_fn(model, n_micro, sh)(p, batch)
        p1, st1, met = adamw_update(p, g, st, ocfg, sharding=sh)
        rec = {"loss": float(loss), "ce": float(ce),
               "grad_norm": float(met["grad_norm"]),
               "moved": collectives.moved_bytes(),
               "grads": sh.gather(g),
               "state": sh.gather_state({"params": p1, "opt_state": st1}),
               "block_bytes": sum(x.numel() * x.element_size()
                                  for x in loop.tree_leaves(p1))}
        step = loop.make_train_step(model, ocfg, n_micro, sh)
        losses = [rec["loss"]]
        for _ in range(steps - 1):
            p1, st1, m = step(p1, st1, batch)
            losses.append(float(m["loss"]))
        rec["losses"] = losses
        rows = loop.local_rows({"tokens": torch.as_tensor(
            batch["tokens"])}, n_micro, ctx)["tokens"].long()
        kw = {"system": system, "compute_dtype": torch.float32}
        with torch.no_grad(), shard_ctx(dc.replace(ctx, rows_local=True)):
            fwd = loop.forward_tree(p, sh.specs, ctx)
            rec["logits"] = transformer.lm_forward(fwd, cfg, rows,
                                                   dense_kw=kw)[0]
        rec["rows"] = rows
        out[label] = rec
    return out


# ---------------------------------------------------------------------------
# The differentiable collectives on (2, 2).
# ---------------------------------------------------------------------------

# axes -> the groups of ranks (by index along the axes, major to minor)
COLL_GROUPS = {("model",): [[0, 1], [2, 3]], ("data",): [[0, 2], [1, 3]],
               ("data", "model"): [[0, 1, 2, 3]]}


def coll_grad_body(rank, inputs, cots):
    """Each differentiable collective on this rank's input (per ``(name,
    axes)`` case), its output and the gradient of ``<out, cot>`` with
    respect to the input."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as c

    mesh = make_test_mesh((2, 2))
    fns = {"gather_slice": lambda x, a: c.diff_all_gather(x, 1, mesh, a),
           "gather_sum": lambda x, a: c.diff_all_gather(x, 1, mesh, a,
                                                        "sum"),
           "all_reduce": lambda x, a: c.diff_all_reduce(x, mesh, a),
           "reduce_scatter": lambda x, a: c.diff_reduce_scatter(x, 1, mesh,
                                                                a),
           "identity": lambda x, a: c.diff_identity(x, mesh, a),
           "slice": lambda x, a: c.diff_slice(x, 1, mesh, a)}
    out = {}
    for (name, axes), xs in inputs.items():
        x = torch.as_tensor(xs[rank]).requires_grad_(True)
        y = fns[name](x, axes)
        (gx,) = torch.autograd.grad(y, x, torch.as_tensor(
            cots[(name, axes)][rank]))
        out[(name, axes)] = (y.detach(), gx, c.axis_index(mesh, axes))
    return out


# ---------------------------------------------------------------------------
# Sharded checkpoints: saved on (2, 2), restored onto (1, 2).
# ---------------------------------------------------------------------------


def ckpt_body(rank, cfg, system, tree, ckpt_dir, n_micro, opt_kw):
    """Step 0 on (2, 2) through ``ft.run_training`` (checkpointed gathered
    at step 1), then on (1, 2) (ranks 0-1) a restart that restores it and
    runs step 1; returns the restored run's loss and its state after step
    1, gathered whole."""
    import torch.distributed as dist

    from repro_torch.convert import from_jax_params
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.api import build_model
    from repro_torch.train import loop
    from repro_torch.train.ft import FtConfig, run_training
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    model = build_model(cfg, system=system, device="cpu")
    ocfg = OptConfig(**opt_kw, moment_dtype=cfg.opt_state_dtype)
    pipe = TokenPipeline(cfg.vocab, 8, 4, seed=1)
    out = {}
    meshes = {"save": make_test_mesh((2, 2)),
              "load": make_test_mesh((1, 2), ranks=range(2))}
    for phase, steps in (("save", 1), ("load", 2)):
        mesh = meshes[phase]
        if phase == "load" and rank >= 2:
            break
        sh = loop.TrainSharding.of(from_jax_params(tree, cfg, "cpu"),
                                   make_ctx(mesh, seq_shard=True))

        def init_state(sh=sh):
            params = from_jax_params(tree, cfg, "cpu")
            return sh.place_state({"params": params, "opt_state":
                                   init_opt_state(params, ocfg)})

        res = run_training(
            init_state=init_state,
            train_step=loop.make_train_step(model, ocfg, n_micro, sh),
            batch_at=pipe.batch_at, sharding=sh,
            cfg=FtConfig(ckpt_dir=ckpt_dir, total_steps=steps, ckpt_every=1,
                         log_fn=lambda s: None))
        dist.barrier(group=mesh.get_group("model") if phase == "load"
                     else None)
        out[phase] = {"history": res["history"],
                      "state": sh.gather_state({"params": res["params"],
                                                "opt_state":
                                                    res["opt_state"]})}
    return out
