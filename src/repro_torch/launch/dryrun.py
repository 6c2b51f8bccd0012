"""Dry run: cost every (architecture x shape x mesh) cell on the meta
device, with no card and no process group (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --system rns [--mesh single|multi|channel] \\
        [--seq-shard] [--channel-shard] [--reduced] [--tag T] \\
        [--out-dir DIR] [--all]

The port runs explicit SPMD, one process a rank, so a cell costs **rank
0's program** on the reference's production mesh
(``launch/mesh.abstract_production_mesh``: (16, 16), (2, 16, 16), or the
channel mesh (85, 3) for P21).  Per cell:

1. the model is built on the meta device; the serving cells of ``rns`` /
   ``sdrns`` prepare it (``ResidueTensor`` leaves), train cells keep it
   float;
2. the per-card parameter, cache and optimizer bytes come from the
   sharding specs (``parallel/sharding.py``), each leaf's bytes over the
   mesh axes its spec splits it on, as the reference's ``sharded_bytes``;
3. the step runs under a :class:`~repro_torch.roofline.op_cost.OpCost`
   count on rank 0's blocks: train -- the sharded train step
   (``train/loop.py`` with a ``TrainSharding``: rank 0's rows of the
   global batch, its blocks of the parameters, ``m`` and ``v``, the loss's
   forward and backward with remat as the config sets it, and AdamW;
   ``--seq-shard`` puts the norms and residual adds on sequence shards);
   prefill -- ``model.prefill`` at ``s_max = S`` and decode --
   ``model.decode`` of one token against an S-long cache (the audio
   family's: at its last decoder position against S frames of encoder
   memory), both on the prepared tree's blocks (``shard_params``).  The
   collectives of the plans add their ring-model bytes;
4. one JSON record is written: the reference's framework-free fields and
   an ``op_cost`` block (operations by kind, bytes, collective bytes, the
   kernel ops' launches and bounds) in place of its ``hlo_cost``;
   ``roofline/report.py`` renders them.

Nothing here is measured: every number is modelled from the counts.
``--all`` runs every cell of ``configs.all_cells()`` on the single and multi
meshes, one subprocess a cell; existing JSONs are kept and a cell that is
not runnable gets a ``_SKIP`` record, and so do the audio family's train
cells: the sharded step runs the decoder-only families (``run_cell``
raises on them).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any

__all__ = ["run_cell", "main", "sharded_bytes"]

DEFAULT_OUT = "experiments/dryrun_torch"
AUDIO_TRAIN = ("the sharded train step runs the decoder-only families; "
               "the audio encoder-decoder trains in one process")


def _cell_filename(arch, shape, mesh_name, system, tag):
    suffix = f"_{tag}" if tag else ""
    return f"{arch}_{shape}_{mesh_name}_{system}{suffix}.json"


def sharded_bytes(shapes: Any, specs: Any, mesh) -> int:
    """Bytes a card holds of a tree: each leaf's bytes over the sizes of
    the mesh axes its spec splits it on (a ResidueTensor: its planes and
    its scale on their own specs)."""
    from repro_torch.numerics.tensor import ResidueTensor
    from repro_torch.parallel.sharding import mesh_shape, spec_axes

    sizes = mesh_shape(mesh)

    def one(shape, itemsize, spec) -> int:
        n = itemsize
        for d in shape:
            n *= d
        denom = 1
        for entry in spec:
            for name in spec_axes(entry):
                denom *= sizes[name]
        return n // max(denom, 1)

    if isinstance(shapes, ResidueTensor):
        planes_shape, scale_shape = shapes.whole_shapes()
        total = one(planes_shape, shapes.planes.element_size(), specs.planes)
        if scale_shape is not None:
            total += one(scale_shape, shapes.scale.element_size(),
                         specs.scale)
        return total
    if isinstance(shapes, dict):
        return sum(sharded_bytes(v, specs[k], mesh)
                   for k, v in shapes.items())
    if isinstance(shapes, (list, tuple)):
        return sum(sharded_bytes(v, s, mesh) for v, s in zip(shapes, specs))
    return one(tuple(shapes.shape), shapes.element_size(), specs)


def _make_mesh(mesh_name: str):
    from repro_torch.core.moduli import P21
    from repro_torch.launch.mesh import abstract_production_mesh

    if mesh_name == "channel":
        # the model axis sized to the serving set's channel count, so the
        # channel plan's all-reduce schedule engages
        return abstract_production_mesh(channel=P21.num_channels)
    return abstract_production_mesh(multi_pod=mesh_name == "multi")


def run_cell(arch: str, shape_name: str, mesh_name: str = "single", *,
             system: str = "bns", seq_shard: bool = False,
             channel_shard: bool = False, reduced: bool = False,
             out_dir: str = DEFAULT_OUT, tag: str = "") -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.params import model_flops_total, param_counts
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import (param_specs, shard_ctx,
                                               shard_params,
                                               specs_from_roles)
    from repro_torch.roofline.op_cost import OpCost
    from repro_torch.train.loop import TrainSharding, make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name]
    mesh = _make_mesh(mesh_name)
    ctx = make_ctx(mesh, seq_shard=seq_shard, channel_shard=channel_shard)
    model = build_model(cfg, system=system, device="meta")
    prepare = system in ("rns", "sdrns") and shape.kind != "train"
    B, S = shape.global_batch, shape.seq_len

    t0 = time.time()
    params = model.init(0, prepare=prepare)
    extra: dict[str, Any] = {}
    resident = sharded_bytes(params, param_specs(params, ctx), mesh)
    batch = model.input_specs(shape)
    if shape.kind == "train":
        opt_cfg = OptConfig(moment_dtype=cfg.opt_state_dtype)
        opt_state = init_opt_state(params, opt_cfg)
        pspecs = param_specs(params, ctx)
        extra["opt_bytes_dev"] = (
            sharded_bytes(opt_state["m"], pspecs, mesh)
            + sharded_bytes(opt_state["v"], pspecs, mesh))
    else:
        cache = model.init_cache(B, S)
        cspecs = specs_from_roles(cache, model.cache_roles(cache), ctx)
        extra["cache_bytes_dev"] = sharded_bytes(cache, cspecs, mesh)
    t_build = time.time() - t0

    if shape.kind == "train":
        sh = TrainSharding.of(params, ctx)
        state = sh.place_state({"params": params, "opt_state": opt_state})
        del params, opt_state
        step = make_train_step(model, opt_cfg, max(cfg.microbatch, 1), sh)
        with OpCost() as oc:
            step(state["params"], state["opt_state"], batch)
    else:
        with shard_ctx(ctx):
            local = shard_params(params, ctx)
            with OpCost() as oc:
                if shape.kind == "prefill":
                    kw = {k: batch[k] for k in ("patches", "frames")
                          if k in batch}
                    model.prefill(local, batch["tokens"], s_max=S, **kw)
                else:
                    # the audio family's self cache holds dec_len rows;
                    # its S-long cache is the encoder memory
                    pos = cfg.dec_len - 1 if cfg.is_encdec else S - 1
                    model.decode(local, batch["token"], cache, pos)
    t_step = time.time() - t0 - t_build

    counts = param_counts(cfg)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "system": system, "tag": tag,
        "n_devices": int(_prod(mesh.axis_sizes)),
        "seq_shard": seq_shard,
        "channel_shard": channel_shard,
        "reduced": reduced,
        "residue_resident": prepare,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "model_flops_total": model_flops_total(cfg, shape),
        "param_bytes_dev": resident,
        **extra,
        "op_cost": {k: v for k, v in oc.as_dict().items() if k != "by_op"},
        "top_ops": _top_ops(oc.by_op),
        "build_s": round(t_build, 2),
        "count_s": round(t_step, 2),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _cell_filename(arch, shape_name, mesh_name,
                                                system, tag))
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def _top_ops(by_op: dict[str, dict[str, int]], n: int = 12) -> list:
    """The ``n`` ops with the most bytes: ``[name, bytes, count]``."""
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1]["bytes"])[:n]
    return [[k, v["bytes"], v["count"]] for k, v in ranked]


def _record_skip(out_dir, arch, shape, mesh_name, system, reason):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _cell_filename(
        arch, shape, mesh_name, system, "").replace(".json", "_SKIP.json"))
    if os.path.exists(path):
        return
    with open(path, "w") as f:
        json.dump({"arch": arch, "shape": shape, "mesh": mesh_name,
                   "skipped": True, "reason": reason}, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "channel"),
                    default="single",
                    help="'channel' = the single-pod mesh with the model "
                         "axis sized to the moduli channel count (pair "
                         "with --channel-shard)")
    ap.add_argument("--system", default="bns",
                    choices=("bns", "rns", "sdrns"),
                    help="number system; rns / sdrns serving cells run "
                         "residue-resident (ResidueTensor-leaf) params")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel train cells (Megatron-SP: "
                         "norms and residual adds on sequence shards over "
                         "the model axis)")
    ap.add_argument("--channel-shard", action="store_true",
                    help="C-split residue-plane layout (moduli channels "
                         "over the model axis)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced() arch dims on the full production mesh")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true",
                    help="every runnable cell on both meshes, one "
                         "subprocess a cell; existing JSONs are kept")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import SHAPES, all_cells, get_config

        jobs = []
        for arch, shape, runnable, reason in all_cells():
            if SHAPES[shape].kind == "train" and get_config(arch).is_encdec:
                runnable, reason = False, AUDIO_TRAIN
            for mesh_name in ("single", "multi"):
                if not runnable:
                    _record_skip(args.out_dir, arch, shape, mesh_name,
                                 args.system, reason)
                    continue
                fn = _cell_filename(arch, shape, mesh_name, args.system,
                                    args.tag)
                if os.path.exists(os.path.join(args.out_dir, fn)):
                    print(f"[skip existing] {fn}")
                    continue
                jobs.append((arch, shape, mesh_name))
        fails = []
        for arch, shape, mesh_name in jobs:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_name,
                   "--system", args.system, "--out-dir", args.out_dir]
            if args.seq_shard:
                cmd.append("--seq-shard")
            if args.channel_shard:
                cmd.append("--channel-shard")
            if args.reduced:
                cmd.append("--reduced")
            if args.tag:
                cmd += ["--tag", args.tag]
            print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
            r = subprocess.run(cmd, timeout=args.timeout)
            if r.returncode != 0:
                fails.append((arch, shape, mesh_name))
                print(f"[FAIL] {arch} x {shape} x {mesh_name}", flush=True)
        print(f"[dryrun --all] done; {len(fails)} failures: {fails}")
        return 1 if fails else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, system=args.system,
                       seq_shard=args.seq_shard,
                       channel_shard=args.channel_shard,
                       reduced=args.reduced, out_dir=args.out_dir,
                       tag=args.tag)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "mesh", "system", "n_devices",
                       "param_bytes_dev", "build_s", "count_s")}, indent=1))
    oc = rec["op_cost"]
    print("op_cost ops/bytes/coll:", oc["ops"], oc["bytes"],
          oc["coll_bytes"])
    print("launches:", oc["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
