"""GPipe pipeline over one mesh axis (port of
``repro/parallel/pipeline.py``).

``pipeline_apply(stage_fn, stage_params, x, mesh=..., axis=...)`` places
stage ``s`` on the member at index ``s`` of ``axis`` and streams ``x``'s
micro-batches through the stages: stage 0 reads micro-batch ``i``, each
later stage receives it from the one before (``send`` / ``recv`` where the
reference ``ppermute``-s), and the last stage's outputs are broadcast to
every member.  Stages run concurrently, one process each, so a stage starts
micro-batch ``i`` as soon as the stage before hands it over: the fill and
drain of the GPipe schedule, whose bubble fraction is ``(S - 1) / (n_micro
+ S - 1)``.

* ``stage_params``: a tree whose leaves lead with the stage dim ``S``
  (every rank may hold the whole stack; each takes its own stage's slice);
* ``x``: ``(n_micro, mb, ...)``, the same on every member, ``n_micro >=
  S``;
* ``stage_fn(params_one_stage, mb) -> mb`` keeps the micro-batch's shape
  and dtype.

The reference's docstring points at a ``tests/test_pipeline.py`` that does
not exist; ``tests/test_torch_compression.py`` holds the port's against the
sequential stack on 2 and 4 ranks.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel import collectives

__all__ = ["pipeline_apply"]


def _stage_slice(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s) for v in tree)
    return tree[s]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run ``x``'s micro-batches through the stages laid out on ``axis``;
    returns the last stage's ``(n_micro, mb, ...)`` outputs on every
    member."""
    S = collectives.axis_size(mesh, (axis,))
    n_micro = x.shape[0]
    if n_micro < S:
        raise ValueError(f"need >= {S} micro-batches to fill the pipeline, "
                         f"got {n_micro}")
    stage = collectives.axis_index(mesh, (axis,))
    lp = _stage_slice(stage_params, stage)
    outs = torch.zeros_like(x)
    for i in range(n_micro):
        inp = x[i] if stage == 0 else collectives.recv(x[i], stage - 1,
                                                       mesh, axis)
        out = stage_fn(lp, inp)
        if stage < S - 1:
            collectives.send(out, stage + 1, mesh, axis)
        else:
            outs[i] = out
    return collectives.broadcast(outs, S - 1, mesh, axis)
