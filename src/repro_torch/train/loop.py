"""Train-step factory: the model's loss, micro-batched gradient
accumulation, AdamW (port of ``repro/train/loop.py``).

``make_train_step(model, opt_cfg, n_micro)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the batch (numpy or
tensors, leading axis B) is cut into ``n_micro`` micro-batches of B /
n_micro rows run one after another, so one micro-batch's activations are
live at a time; their gradients are summed in ``cfg.grad_accum_dtype`` and
divided by ``n_micro``, as are loss and cross entropy.  The parameters it
returns are new tensors; the ones passed in are not changed.

With ``sharding`` (a :class:`TrainSharding`: a shard context and the
``param_specs`` of the whole tree) the step is one rank's program of the
reference's sharded step, explicit SPMD over ``torch.distributed``: the
parameters and AdamW's ``m`` and ``v`` are this rank's blocks
(:meth:`TrainSharding.place_state`), FSDP over ``dp`` on the non-TP dim
and TP over ``tp``.  Each call takes the global batch and keeps this dp
rank's rows of every micro-batch (``batch_spec_train`` on the
micro-batch's rows, so micro-batch m holds the rows of the one-process
step's micro-batch m); the forward runs on them with the context's
``rows_local`` set.  In the forward tree every dense weight, expert stack
and the embedding table is a ``ShardedParam`` (``models/linear.py`` runs
its plan); every other leaf is gathered whole there (backward: summed over
dp where FSDP split it, the local block over tp).  The loss and the cross
entropy are the global batch's, normalized by its count of labelled
tokens, on every rank.  FSDP leaves' gradients come back reduce-scattered
through autograd; those of leaves replicated over dp are all-reduced over
it once a step.  AdamW runs on the blocks and clips by the global norm
(each leaf counted once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.api import Model
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (ShardCtx, ShardedParam, Spec,
                                           gather_tree, mesh_shape,
                                           param_specs, place_tree,
                                           shard_ctx, spec_axes,
                                           spec_axes_of)
from repro_torch.quant.quant import true_divide
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_grad_fn", "make_eval_step",
           "loss_and_grads", "TrainSharding", "forward_tree",
           "local_rows"]


@dataclasses.dataclass(frozen=True)
class TrainSharding:
    """Where a train state's float leaves sit: the shard context and the
    ``param_specs`` of the whole parameter tree (``m`` and ``v`` take the
    same specs)."""

    ctx: ShardCtx
    specs: Any
    shapes: Any            # the whole leaves' shapes

    @classmethod
    def of(cls, params: Any, ctx: ShardCtx) -> "TrainSharding":
        """From a whole parameter tree (or a tree of anything with
        ``.shape``)."""
        return cls(ctx, param_specs(params, ctx),
                   tree_map(lambda x: tuple(x.shape), params))

    def state_specs(self) -> dict[str, Any]:
        """The specs of a train state ``{"params", "opt_state"}``."""
        return {"params": self.specs,
                "opt_state": {"m": self.specs, "v": self.specs,
                              "step": Spec()}}

    def check_blocks(self, params: Any) -> None:
        """Raise unless every leaf is this rank's block (a whole tree
        handed to a sharded step would run replicated)."""
        sizes = mesh_shape(self.ctx.mesh)

        def one(x, spec, shape):
            want = tuple(d // math.prod(sizes[a] for a in spec_axes(e))
                         for d, e in zip(shape, spec))
            if tuple(x.shape) != want:
                raise ValueError(f"a sharded step takes this rank's blocks: "
                                 f"a leaf of shape {tuple(x.shape)} where "
                                 f"its block is {want} (place the state "
                                 f"with TrainSharding.place_state)")

        tree_map(one, params, self.specs, self.shapes)

    def place(self, tree: Any) -> Any:
        return place_tree(tree, self.specs, self.ctx)

    def gather(self, tree: Any) -> Any:
        return gather_tree(tree, self.specs, self.ctx)

    def _state(self, state: dict[str, Any], fn) -> dict[str, Any]:
        opt = state["opt_state"]
        return {"params": fn(state["params"]),
                "opt_state": {"m": fn(opt["m"]), "v": fn(opt["v"]),
                              "step": opt["step"]}}

    def place_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """``{"params", "opt_state"}`` whole -> this rank's blocks."""
        return self._state(state, self.place)

    def gather_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """This rank's blocks -> the whole state (collective)."""
        return self._state(state, self.gather)


def _split_micro(batch: dict[str, Any], n: int) -> list[dict[str, Any]]:
    """(B, ...) leaves -> n dicts of (B / n, ...) rows."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        B = x.shape[0]
        assert B % n == 0, (B, n)
        for i in range(n):
            out[i][key] = x[i * (B // n): (i + 1) * (B // n)]
    return out


def loss_and_grads(model: Model, params: Any, batch: dict[str, Any],
                   forward: Callable[[Any], Any] = lambda tree: tree):
    """``((loss, ce), grads)`` of ``model.loss`` at ``params``; a leaf the
    loss does not reach gets a zero gradient.  ``forward`` maps the tree
    of leaves to the tree the loss takes (the sharded step's
    :func:`forward_tree`)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss, ce = model.loss(forward(tree), batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)])
    grads = tree_map(lambda _: next(gs), params)
    return (loss.detach(), ce.detach()), grads


_EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def _planned(path: tuple[str, ...], leaf: torch.Tensor) -> bool:
    """Whether the model code consumes a leaf through a plan of its block
    (a dense weight, an expert stack, the embedding table) rather than
    whole."""
    if path[-1] == "w":
        return len(path) < 2 or path[-2] != "router"
    if path[-1] in _EXPERT_STACKS:
        return leaf.dim() == 3
    return path[-2:] == ("embed", "table")


def forward_tree(leaves: Any, specs: Any, ctx: ShardCtx,
                 path: tuple[str, ...] = ()) -> Any:
    """The sharded forward's parameter tree over this rank's blocks
    (module docstring)."""
    if isinstance(leaves, dict):
        return {k: forward_tree(v, specs[k], ctx, path + (k,))
                for k, v in leaves.items()}
    if isinstance(leaves, list):
        return [forward_tree(v, s, ctx, path) for v, s in zip(leaves,
                                                              specs)]
    p = ShardedParam(leaves, specs, ctx)
    if _planned(path, leaves):
        return p
    return p.whole() if spec_axes_of(specs) else leaves


def local_rows(batch: dict[str, Any], n_micro: int, ctx: ShardCtx
                ) -> dict[str, Any]:
    """This dp rank's rows of each micro-batch, micro-batch by
    micro-batch."""
    n = collectives.axis_size(ctx.mesh, ctx.dp)
    out = {}
    for key, x in batch.items():
        B = x.shape[0]
        if B % (n_micro * n):
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"micro-batches over {n} dp ranks")
        x = x.reshape(n_micro, B // n_micro, *x.shape[1:])
        x = collectives.block_of(x, 1, ctx.mesh, ctx.dp)
        out[key] = x.reshape(-1, *x.shape[2:])
    return out


def _sum_replicated(grads: Any, specs: Any, ctx: ShardCtx) -> Any:
    """Each gradient summed over the dp axes its leaf is replicated on
    (the ones FSDP splits were reduce-scattered by autograd)."""
    def one(g, spec):
        axes = tuple(a for a in ctx.dp if a not in spec_axes_of(spec))
        return collectives.all_reduce(g, ctx.mesh, axes) if axes else g

    return tree_map(one, grads, specs)


def make_grad_fn(model: Model, n_micro: int = 1,
                 sharding: TrainSharding | None = None) -> Callable:
    """The step's gradient half: ``grads_fn(params, batch) -> ((loss, ce),
    grads)``, micro-batched; with ``sharding`` on this rank's blocks and
    rows, each gradient summed over the dp ranks (module docstring)."""
    accum = getattr(torch, model.cfg.grad_accum_dtype)
    if sharding is not None and model.cfg.is_encdec:
        raise ValueError("the sharded train step runs the decoder-only "
                         "families, not the audio encoder-decoder")
    n_micro = max(n_micro, 1)

    def grads_of(params, mb):
        if sharding is None:
            return loss_and_grads(model, params, mb)
        return loss_and_grads(model, params, mb, lambda tree: forward_tree(
            tree, sharding.specs, sharding.ctx))

    def grads_fn(params: Any, batch: dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if sharding is not None:
            batch = local_rows(batch, n_micro, sharding.ctx)
        if n_micro == 1:
            (loss, ce), grads = grads_of(params, batch)
        else:
            gsum, lsum, csum = None, 0.0, 0.0
            for mb in _split_micro(batch, n_micro):
                (lval, c), g = grads_of(params, mb)
                g = tree_map(lambda b: b.to(accum), g)
                gsum = g if gsum is None else tree_map(
                    lambda a, b: (a + b).to(accum), gsum, g)
                lsum, csum = lsum + lval, csum + c
                del g
            grads = tree_map(lambda g: true_divide(g, n_micro), gsum)
            loss, ce = true_divide(lsum, n_micro), true_divide(csum, n_micro)
        if sharding is not None:
            grads = _sum_replicated(grads, sharding.specs, sharding.ctx)
        return (loss, ce), grads

    if sharding is None:
        return grads_fn

    def sharded_grads_fn(params: Any, batch: dict[str, Any]):
        sharding.check_blocks(params)
        with shard_ctx(dataclasses.replace(sharding.ctx, rows_local=True)):
            return grads_fn(params, batch)

    return sharded_grads_fn


def make_train_step(model: Model, opt_cfg: OptConfig, n_micro: int = 1,
                    sharding: TrainSharding | None = None) -> Callable:
    grads_fn = make_grad_fn(model, n_micro, sharding)

    def train_step(params: Any, opt_state: Any, batch: dict[str, Any]):
        (loss, ce), grads = grads_fn(params, batch)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg,
                                                      sharding=sharding)
        return params, opt_state, {"loss": loss, "ce": ce, **opt_metrics}

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params: Any, batch: dict[str, Any]):
        loss, ce = model.loss(params, batch)
        return {"loss": loss, "ce": ce}

    return eval_step
