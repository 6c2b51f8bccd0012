"""Weights and inputs made from the seed, the same for the program and the
reference.

Every block of random numbers has its own generator, seeded from the run's
seed and the block's name (:func:`block_seed`), so any block can be made
again after the window, alone, for the reference.  Blocks are drawn on the
device in one call each.  A decoder's weights are its family's
(``perfbench/families/``); a CNN's are here.
"""
from __future__ import annotations

import hashlib

import torch


def block_seed(seed: int, *name: object) -> int:
    """A 63-bit generator seed for block ``name`` of run ``seed`` (any whole
    number, however large)."""
    key = "/".join(str(p) for p in (seed, *name)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def normal(n: int, seed: int, *name: object, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, *name))
    return torch.randn(n, generator=gen, device=device)


# -- CNN (Glorot-normal weights, zero biases) -------------------------------

def cnn_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    """``{"l<i>": (d_in, d_out)}`` of every conv (im2col: taps by (row,
    column), channels innermost) and fc layer."""
    out = {}
    hw, c = cfg["input_size"], cfg["input_channels"]
    for i, layer in enumerate(cfg["layers"]):
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            out[f"l{i}"] = (k * k * c, c_out)
            hw, c = hw // stride, c_out
        elif layer[0] == "pool":
            hw //= layer[1]
        else:
            d_in = hw * hw * c if hw else c
            out[f"l{i}"] = (d_in, layer[1])
            hw, c = 0, layer[1]
    return out


def cnn_params(cfg: dict, seed: int, device) -> dict:
    shapes = cnn_shapes(cfg)
    flat = normal(sum(a * b for a, b in shapes.values()), seed, "cnn",
                  device=device)
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        w = flat[at: at + a * b].view(a, b).mul_((2.0 / (a + b)) ** 0.5)
        out[name] = {"w": w, "b": torch.zeros(b, device=device)}
        at += a * b
    return out
