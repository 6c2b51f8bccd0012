"""AdamW with a warm-up and cosine schedule and global-norm clipping, as
functions of parameter trees (port of ``repro/train/optimizer.py``).

The state is a plain tree ``{"m", "v", "step"}`` whose ``m`` and ``v``
mirror the parameters, in ``moment_dtype``.  All arithmetic is f32; the
bias corrections use the step as f32.  Weight decay applies to leaves of
two or more dimensions, counting a layer stack's axis as the reference's
stacked leaves do: a per-layer norm scale (the reference's ``(L, d)``
leaf) is decayed, the final norm's ``(d,)`` is not.

On a sharded state (``train/loop.py``'s ``TrainSharding``) the update runs
on each rank's blocks, elementwise as on whole leaves; the global norm
sums each leaf's squares over the mesh axes its spec splits it on, so a
leaf counts once whether it is split or replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.quant.quant import true_divide
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_at",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * peak_lr``;
    an f32 0-d tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = true_divide(cfg.peak_lr * step, max(cfg.warmup_steps, 1))
    frac = torch.clamp(true_divide(step - cfg.warmup_steps,
                                   max(cfg.total_steps - cfg.warmup_steps,
                                       1)), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Any, cfg: OptConfig) -> dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Any, sharding: Any = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  With
    ``sharding`` the leaves are this rank's blocks: the squares of the
    leaves split over the same axes are summed locally, then over those
    axes (one all-reduce a set of axes), a replicated leaf's locally."""
    if sharding is None:
        return torch.sqrt(sum(x.to(torch.float32).square().sum()
                              for x in tree_leaves(tree)))
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import mesh_shape, spec_axes_of

    ctx = sharding.ctx
    order = list(mesh_shape(ctx.mesh))
    sums: dict[tuple[str, ...], torch.Tensor] = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(sharding.specs)):
        axes = tuple(a for a in order if a in spec_axes_of(spec))
        sq = x.to(torch.float32).square().sum()
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    return torch.sqrt(sum(collectives.all_reduce(v, ctx.mesh, axes)
                          for axes, v in sums.items()))


def adamw_update(params: Any, grads: Any, state: dict[str, Any],
                 cfg: OptConfig, sharding: Any = None
                 ) -> tuple[Any, dict[str, Any], dict[str, Any]]:
    """One AdamW step: ``(params', state', {"lr", "grad_norm"})``; with
    ``sharding`` on this rank's blocks (module docstring)."""
    step = state["step"] + 1
    dev = step.device
    gnorm = global_norm(grads, sharding)
    scale = torch.clamp(_f32(cfg.clip_norm, dev)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(b2, dev), stepf)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(depth, p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() + depth >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p32 = p.to(torch.float32) - lr * delta
        return p32.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, params, grads, state["m"], state["v"],
                   with_depth=True)
    new = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
