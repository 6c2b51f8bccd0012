"""Carry parameters across from the JAX package, as numpy arrays.

:func:`load_npz` reads the ``params/...`` keys of a checkpoint written by
``repro/train/checkpoint.py`` into a nested dict of numpy arrays;
:func:`from_jax_params` turns such a tree (layers stacked on axis 0, as in
the npz) into the port's parameters (a list of per-layer dicts of tensors,
and for the audio family one list for ``enc_layers`` and one for
``dec_layers``; the hybrid family's ``shared`` block, not stacked, comes
across as it is;
the moe family's router and ``(E, K, N)`` expert stacks and the ssm
family's Mamba2 layers are per-layer leaves like any other).  bfloat16
leaves (a ``param_dtype="bfloat16"`` config such as grok-1-314b) come
across as float32, which holds them exactly.  Residue preparation then
runs in the port (``Model.prepare_params``).  :func:`to_jax_params` is the
inverse, for a float tree or anything that mirrors one (the optimizer's
moments).  :func:`cnn_from_jax_params` carries the reference's CNN tree
(``data/cifar.py::init_cnn``) across the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["load_npz", "from_jax_params", "to_jax_params",
           "cnn_from_jax_params"]


def load_npz(path: str) -> dict[str, Any]:
    """``params/a/b/c`` npz keys -> ``{"a": {"b": {"c": array}}}``."""
    tree: dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] != "params":
                continue
            node = tree
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    if not tree:
        raise ValueError(f"{path} holds no params/... keys")
    return tree


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    arr = np.asarray(node)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16 of its own
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr).to(device)


def _layer(node, i: int):
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node)


def from_jax_params(np_tree: dict[str, Any], cfg: ArchConfig,
                    device: torch.device | str) -> dict[str, Any]:
    """The reference's parameter tree (numpy, layers stacked on axis 0) ->
    the port's parameters on ``device``."""
    stacks = ({"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
              if cfg.is_encdec else {"layers": cfg.n_layers})
    out = {k: _to_torch(v, device) for k, v in np_tree.items()
           if k not in stacks}
    for key, want in stacks.items():
        if key not in np_tree:
            raise ValueError(f"tree holds no {key!r} for the "
                             f"{cfg.family} family")
        n = len(_first_leaf(np_tree[key]))
        if n != want:
            raise ValueError(f"tree holds {n} {key}, config says {want}")
        out[key] = [_to_torch(_layer(np_tree[key], i), device)
                    for i in range(n)]
    return out


def cnn_from_jax_params(np_tree: dict[str, Any],
                        device: torch.device | str) -> dict[str, Any]:
    """The reference's ``init_cnn`` tree (``{"l<i>": {"w", "b"}}``, as
    numpy) -> the port's ``cnn_forward`` parameters on ``device``."""
    out = {}
    for name, layer in np_tree.items():
        if set(layer) != {"w", "b"}:
            raise ValueError(f"CNN layer {name!r} holds {sorted(layer)}, "
                             "expected 'w' and 'b'")
        out[name] = _to_torch(layer, device)
    return out


def to_jax_params(tree: Any) -> Any:
    """The port's tree -> the reference's, as numpy: each list of layers
    stacked on a new axis 0 (nested lists on nested axes), bfloat16
    leaves as float32 (numpy has no bfloat16), 0-d tensors as 0-d arrays."""
    if isinstance(tree, dict):
        return {k: to_jax_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack([to_jax_params(v) for v in tree])
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"to_jax_params takes float tensors, got "
                        f"{type(tree).__name__} (residue-resident trees "
                        "carry no float weights)")
    t = tree.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack(layers)
