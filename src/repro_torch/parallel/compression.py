"""Compressed gradient mean with error feedback (port of
``repro/parallel/compression.py``).

An all-reduce is a reduce-scatter followed by an all-gather.  The reduce
must stay exact (sums of quantized values would compound the error), but
the gather only broadcasts finished values, which can be quantized.  Per
leaf, over the ranks of a mesh's axes (n of them):

1. an exact f32 ``reduce_scatter_tensor`` of ``grad + error``, over n;
2. a scale shared by every rank (an all-reduce max of ``|shard|``, over
   127), the owned shard quantized to int8 and its residual kept;
3. an int8 all-gather (a quarter of the f32 bytes) and the rescale;
4. error feedback: ``n * residual`` on the owned shard's rows of the new
   error state (the next reduce divides it by n again).

Scalars, and leaves whose leading dim does not divide n, take an exact f32
all-reduce over n instead, with a zero error.  Each rank calls with its own
gradients (the data-parallel situation); every rank gets the same mean.
Nothing in the training loop calls it, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.parallel import collectives

__all__ = ["init_error_state", "compressed_grad_mean",
           "make_compressed_mean"]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of dict / list trees."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def init_error_state(grads: Any) -> Any:
    """A zero f32 error state shaped like ``grads``."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def _quantize_mean(x: torch.Tensor, err: torch.Tensor, mesh,
                   axes: tuple[str, ...]) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The mean of ``x`` over ``axes`` with an int8 gather and error
    feedback: ``(mean, new_err)``."""
    n = collectives.axis_size(mesh, axes)
    xf = x.to(torch.float32) + err
    if n == 1:
        return xf.to(x.dtype), torch.zeros_like(xf)
    lead = x.shape[0] if x.dim() else 0
    if x.dim() == 0 or lead % n:
        mean = collectives.all_reduce(xf, mesh, axes) / n
        return mean.to(x.dtype), torch.zeros_like(xf)
    shard = collectives.reduce_scatter(xf, mesh, axes) / n
    gmax = collectives.all_reduce(shard.abs().max().reshape(1), mesh, axes,
                                  op="max")[0]
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(shard / scale), -127, 127).to(torch.int8)
    resid = shard - q.to(torch.float32) * scale
    gathered = collectives.all_gather(q, 0, mesh, axes)
    mean = gathered.to(torch.float32) * scale
    rows = lead // n
    err_new = torch.zeros_like(xf)
    off = collectives.axis_index(mesh, axes) * rows
    err_new[off:off + rows] = n * resid
    return mean.to(x.dtype), err_new


def compressed_grad_mean(grads: Any, err_state: Any, mesh,
                         axes: tuple[str, ...]) -> tuple[Any, Any]:
    """Per leaf: the compressed mean of every rank's ``grads`` over the
    mesh's ``axes``, and the new error state."""
    out = _map(lambda g, e: _quantize_mean(g, e, mesh, axes), grads,
               err_state)
    return _pick(out, 0), _pick(out, 1)


def _pick(tree, i):
    """Element ``i`` of every ``(mean, err)`` pair of a mapped tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def make_compressed_mean(mesh, axes: tuple[str, ...]):
    """``f(grads, err) -> (mean_grads, err')`` over ``mesh``'s ``axes``."""
    def fn(grads, err):
        return compressed_grad_mean(grads, err, mesh, tuple(axes))

    return fn
