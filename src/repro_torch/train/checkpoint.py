"""Step-atomic checkpoints of parameter trees, in the reference's npz
layout (port of ``repro/train/checkpoint.py``).

One ``ckpt_<step>.npz`` a checkpoint holds every leaf under its
``/``-joined key path, with each layer list stacked on a leading axis as
the reference stacks its layers (``params/layers/attn/wq/w`` is ``(L, K,
N)``), plus a small ``manifest.json``.  So a checkpoint the reference wrote
restores here and one written here restores in the reference.  Writes go
to a temporary name and are ``os.replace``d, so a crash mid-write never
corrupts the latest checkpoint.  Retention keeps the newest ``keep``.

:func:`restore` rebuilds a template tree: each leaf is checked against the
template's shape (a layer list against the stacked axis), cast to the
template leaf's dtype and put on its device.  A float <-> integer cast is
refused: integer leaves are exact and a cast across kinds is a structure
mismatch.  bfloat16 leaves are written as float32 (numpy has no bfloat16;
float32 holds them exactly); a reference checkpoint's bfloat16 leaves are
read bit for bit.

Residue-resident (prepared) trees take the same path, in the reference's
layout: each ``ResidueTensor`` is written as ``<path>/0`` (its planes,
layers stacked on axis 0) and ``<path>/1`` (its scale), and :func:`restore`
rebuilds it from a prepared template, taking ``mset``, ``layout``,
``qbits`` and ``max_abs`` from the template; the planes are exact integer
encodings, so the float <-> integer refusal guards them too.  A sharded
tensor is saved whole; a template must be whole.

A sharded train state (``train/loop.py``'s ``TrainSharding``) saves in the
same layout, gathered whole (``ft.py`` gathers it on every rank and the
mesh's first rank writes), so it restores onto one process or onto any
mesh: :func:`restore` with ``sharding`` fills a template of this rank's
blocks, cutting each block from the whole leaf it reads.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.convert import to_jax_params
from repro_torch.numerics.tensor import ResidueTensor

__all__ = ["save", "restore", "latest_step", "all_steps"]

_FMT = "ckpt_{step:010d}.npz"
_RE = re.compile(r"ckpt_(\d{10})\.npz$")


def _flatten(node: Any, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = node


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Write ``tree`` at ``step``; returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    _flatten(to_jax_params(tree), "", flat)
    path = os.path.join(directory, _FMT.format(step=step))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    mtmp = os.path.join(directory, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump({"step": step, "n_leaves": len(flat)}, f)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))
    for s in all_steps(directory)[:-keep]:
        try:
            os.remove(os.path.join(directory, _FMT.format(step=s)))
        except OSError:
            pass
    return path


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _RE.match(name)))


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _leaf(key: str, arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"template {tuple(tmpl.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bfloat16 leaf read without its numpy dtype: the high half of
        # an f32
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    t_int = not (tmpl.dtype.is_floating_point or tmpl.dtype.is_complex)
    if np.issubdtype(arr.dtype, np.integer) != t_int:
        raise ValueError(
            f"dtype-kind mismatch for {key}: ckpt {arr.dtype} vs template "
            f"{tmpl.dtype}: integer leaves are exact and must not cast "
            "across kinds")
    return torch.from_numpy(np.array(arr)).to(
        device=tmpl.device, dtype=tmpl.dtype)


def _block(arr: np.ndarray, spec, ctx) -> np.ndarray:
    """This rank's block of a whole leaf on ``spec``."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import spec_axes

    for d, e in enumerate(spec):
        axes = spec_axes(e)
        if axes:
            n = collectives.axis_size(ctx.mesh, axes)
            size = arr.shape[d] // n
            i = collectives.axis_index(ctx.mesh, axes)
            arr = arr.take(range(i * size, (i + 1) * size), axis=d)
    return arr


def _rebuild(node: Any, key: str, flat: dict[str, np.ndarray],
             index: tuple[int, ...], lens: tuple[int, ...],
             specs: Any = None, ctx: Any = None) -> Any:
    """``index``: the position in the enclosing layer lists, ``lens``:
    their lengths (the stacked axes the leaf must have); ``specs``: the
    blocks' specs on ``ctx`` (a template of blocks)."""
    if isinstance(node, dict):
        return {k: _rebuild(v, f"{key}/{k}" if key else str(k), flat, index,
                            lens, None if specs is None else specs[k], ctx)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_rebuild(v, key, flat, index + (i,), lens + (len(node),),
                         None if specs is None else specs[i], ctx)
                for i, v in enumerate(node)]
    if isinstance(node, ResidueTensor):
        if node.sharding is not None:
            raise ValueError(f"{key}: restore into a whole ResidueTensor "
                             "template (this one is sharded)")
        planes = _rebuild(node.planes, f"{key}/0", flat, index, lens)
        scale = None if node.scale is None else _rebuild(
            node.scale, f"{key}/1", flat, index, lens)
        return dataclasses.replace(node, planes=planes, scale=scale)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if arr.shape[:len(lens)] != lens:
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"layer stacks of {lens}")
    arr = arr[index]
    if specs is not None:
        arr = _block(arr, specs, ctx)
    return _leaf(key, arr, node)


def restore(directory: str, template: Any, step: int | None = None, *,
            sharding: Any = None) -> Any:
    """Rebuild ``template`` from the checkpoint at ``step`` (default: the
    latest).  With ``sharding`` (a ``TrainSharding``) the template is a
    train state ``{"params", "opt_state"}`` of this rank's blocks."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, _FMT.format(step=step))) as data:
        flat = {k: data[k] for k in data.files}
    if sharding is None:
        return _rebuild(template, "", flat, (), ())
    return _rebuild(template, "", flat, (), (), sharding.state_specs(),
                    sharding.ctx)
