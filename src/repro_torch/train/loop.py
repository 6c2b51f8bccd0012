"""Train-step factory: the model's loss, micro-batched gradient
accumulation, AdamW (port of ``repro/train/loop.py``).

``make_train_step(model, opt_cfg, n_micro)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the batch (numpy or
tensors, leading axis B) is cut into ``n_micro`` micro-batches of B /
n_micro rows run one after another, so one micro-batch's activations are
live at a time; their gradients are summed in ``cfg.grad_accum_dtype`` and
divided by ``n_micro``, as are loss and cross entropy.  The parameters it
returns are new tensors; the ones passed in are not changed.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.api import Model
from repro_torch.quant.quant import true_divide
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]


def _split_micro(batch: dict[str, Any], n: int) -> list[dict[str, Any]]:
    """(B, ...) leaves -> n dicts of (B / n, ...) rows."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        B = x.shape[0]
        assert B % n == 0, (B, n)
        for i in range(n):
            out[i][key] = x[i * (B // n): (i + 1) * (B // n)]
    return out


def loss_and_grads(model: Model, params: Any, batch: dict[str, Any]):
    """``((loss, ce), grads)`` of ``model.loss`` at ``params``; a leaf the
    loss does not reach gets a zero gradient."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss, ce = model.loss(tree, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)])
    grads = tree_map(lambda _: next(gs), params)
    return (loss.detach(), ce.detach()), grads


def make_train_step(model: Model, opt_cfg: OptConfig,
                    n_micro: int = 1) -> Callable:
    accum = getattr(torch, model.cfg.grad_accum_dtype)

    def train_step(params: Any, opt_state: Any, batch: dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if n_micro <= 1:
            (loss, ce), grads = loss_and_grads(model, params, batch)
        else:
            gsum, lsum, csum = None, 0.0, 0.0
            for mb in _split_micro(batch, n_micro):
                (lval, c), g = loss_and_grads(model, params, mb)
                g = tree_map(lambda b: b.to(accum), g)
                gsum = g if gsum is None else tree_map(
                    lambda a, b: (a + b).to(accum), gsum, g)
                lsum, csum = lsum + lval, csum + c
                del g
            grads = tree_map(lambda g: true_divide(g, n_micro), gsum)
            loss, ce = true_divide(lsum, n_micro), true_divide(csum, n_micro)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "ce": ce, **opt_metrics}

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params: Any, batch: dict[str, Any]):
        loss, ce = model.loss(params, batch)
        return {"loss": loss, "ce": ce}

    return eval_step
