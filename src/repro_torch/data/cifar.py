"""Synthetic CIFAR-10-like data and the paper's DNN evaluation networks.

The port of ``repro/data/cifar.py``.  The paper evaluates SD-RNS on AlexNet
and VGG-16 over CIFAR-10; with no download, this module provides:

* :func:`synthetic_cifar`, a deterministic 10-class 32 x 32 x 3 set of
  Gaussian blobs over fixed per-class templates (numpy's ``default_rng``
  streams, so images and labels equal the reference's bit for bit);
* CIFAR-scale AlexNet and VGG-16 (:data:`ALEXNET`, :data:`VGG16`) on an
  im2col convolution whose every matmul, convolutions and fc layers alike,
  goes through :func:`repro_torch.models.linear.dense`: under ``system=
  "rns"`` the residue matmul kernel (B1), under ``"sdrns"`` the SD-RNS
  kernels (B6, B7 at M <= 8), under ``"bns"`` a float matmul;
* :func:`op_counts`, the exact (adds, muls) of one inference, the mixes
  that the Eq. 3 delay model (``core/cost_model.py``) is read at.

The kernels follow the tensors' device: ``cnn_forward`` takes the
reference's ``dense_kw`` without ``impl``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import linear

__all__ = ["synthetic_cifar", "init_cnn", "cnn_forward", "ALEXNET", "VGG16",
           "CnnSpec", "op_counts", "dense_shapes"]


def synthetic_cifar(n: int, *, seed: int = 0,
                    split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """(images (n, 32, 32, 3) f32 in [0, 1], labels (n,) int32)."""
    rng = np.random.default_rng(seed + (10_007 if split == "test" else 0))
    tmpl_rng = np.random.default_rng(1234)           # shared class templates
    templates = tmpl_rng.random((10, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    noise = rng.normal(0, 0.25, size=(n, 32, 32, 3)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0.0, 1.0)
    return images, labels


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    """layers: ("conv", c_out, k, stride) | ("pool", k) | ("fc", d_out)."""

    name: str
    layers: tuple[tuple, ...]
    input_hw: int = 32
    input_c: int = 3
    n_classes: int = 10


# Classic AlexNet shape adapted to 32x32 CIFAR inputs.
ALEXNET = CnnSpec("alexnet", (
    ("conv", 64, 3, 1), ("pool", 2),
    ("conv", 192, 3, 1), ("pool", 2),
    ("conv", 384, 3, 1),
    ("conv", 256, 3, 1),
    ("conv", 256, 3, 1), ("pool", 2),
    ("fc", 1024), ("fc", 1024), ("fc", 10),
))

VGG16 = CnnSpec("vgg16", (
    ("conv", 64, 3, 1), ("conv", 64, 3, 1), ("pool", 2),
    ("conv", 128, 3, 1), ("conv", 128, 3, 1), ("pool", 2),
    ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("conv", 256, 3, 1),
    ("pool", 2),
    ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1),
    ("pool", 2),
    ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1),
    ("pool", 2),
    ("fc", 4096), ("fc", 4096), ("fc", 10),
))


def op_counts(spec: CnnSpec) -> dict[str, int]:
    """Exact MAC-level (adds, muls) for one inference of the network.

    Each output element of a conv with fan-in F = k*k*c_in costs F muls and
    F-1 adds (+1 add for bias); fc likewise.  Pooling costs k*k-1 adds per
    output (max treated as compare-adds, the paper's 'addition-class' ops).
    """
    adds = muls = 0
    hw, c = spec.input_hw, spec.input_c
    for layer in spec.layers:
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            out_hw = hw // stride
            fan_in = k * k * c
            n_out = out_hw * out_hw * c_out
            muls += n_out * fan_in
            adds += n_out * fan_in          # (F-1) accum + 1 bias
            hw, c = out_hw, c_out
        elif layer[0] == "pool":
            k = layer[1]
            out_hw = hw // k
            adds += out_hw * out_hw * c * (k * k - 1)
            hw = out_hw
        else:  # fc
            d_out = layer[1]
            d_in = hw * hw * c if hw else c
            muls += d_in * d_out
            adds += d_in * d_out
            hw, c = 0, d_out
    return {"adds": adds, "muls": muls}


def dense_shapes(spec: CnnSpec, batch: int) -> list[tuple[int, int, int]]:
    """``(M, K, N)`` of each ``dense`` call of one :func:`cnn_forward` over
    ``batch`` images, in order: a conv's rows are its output pixels."""
    out = []
    hw, c = spec.input_hw, spec.input_c
    for layer in spec.layers:
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            hw //= stride
            out.append((batch * hw * hw, k * k * c, c_out))
            c = c_out
        elif layer[0] == "pool":
            hw //= layer[1]
        else:
            d_in = hw * hw * c if hw else c
            out.append((batch, d_in, layer[1]))
            hw, c = 0, layer[1]
    return out


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k*k*C) patches, zero padding (k-1)//2,
    taps in (di, dj) order with the channels innermost."""
    B, H, W, C = x.shape
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    Ho, Wo = H // stride, W // stride
    cols = [xp[:, di:di + H:stride, dj:dj + W:stride, :]
            for di in range(k) for dj in range(k)]
    return torch.cat(cols, dim=-1)[:, :Ho, :Wo, :]


def init_cnn(gen: torch.Generator, spec: CnnSpec,
             device="cuda") -> dict[str, Any]:
    """Float parameters ``{"l<i>": {"w": (d_in, d_out), "b": (d_out,)}}``
    for every conv and fc layer (Glorot-scaled normal weights, zero
    biases), drawn from ``gen`` on ``device``."""
    params: dict[str, Any] = {}
    hw, c = spec.input_hw, spec.input_c
    for i, layer in enumerate(spec.layers):
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            d_in, d_out = k * k * c, c_out
            hw, c = hw // stride, c_out
        elif layer[0] == "pool":
            hw //= layer[1]
            continue
        else:
            d_out = layer[1]
            d_in = hw * hw * c if hw else c
            hw, c = 0, d_out
        params[f"l{i}"] = {
            **linear.init_dense(gen, d_in, d_out, device=device),
            "b": torch.zeros(d_out, dtype=torch.float32, device=device)}
    return params


def cnn_forward(params: dict[str, Any], spec: CnnSpec, images: torch.Tensor,
                *, dense_kw: dict[str, Any] | None = None) -> torch.Tensor:
    """images (B, 32, 32, 3) f32 -> logits (B, n_classes) f32."""
    dense_kw = dense_kw or {"system": "bns", "compute_dtype": torch.float32}
    x = images
    for i, layer in enumerate(spec.layers):
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            patches = _im2col(x, k, stride)
            B, Ho, Wo, Fi = patches.shape
            y = linear.dense(params[f"l{i}"], patches.reshape(B * Ho * Wo, Fi),
                             **dense_kw)
            y = y.reshape(B, Ho, Wo, c_out) + params[f"l{i}"]["b"]
            x = torch.relu(y)
        elif layer[0] == "pool":
            k = layer[1]
            B, H, W, C = x.shape
            x = x.reshape(B, H // k, k, W // k, k, C).amax(dim=(2, 4))
        else:
            B = x.shape[0]
            x = x.reshape(B, -1)
            y = linear.dense(params[f"l{i}"], x, **dense_kw)
            y = y + params[f"l{i}"]["b"]
            is_last = i == len(spec.layers) - 1
            x = y if is_last else torch.relu(y)
    return x.to(torch.float32)
