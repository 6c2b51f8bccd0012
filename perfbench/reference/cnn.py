"""Plain PyTorch reference of the paper's CNN inference under the residue
number system's arithmetic.

Convolutions are im2col products (taps by (row, column) with the channels
innermost, zero padding ``(k - 1) // 2``), followed by the bias and a ReLU;
pooling takes the maximum of each ``k x k`` window; fc layers are plain
products (ReLU after all but the last).  Every product quantizes its weight
symmetrically per output channel and its activation per row to
``bits``-bit codes; the integer product is exact (float32 products with
TF32 off: every sum stays below 2**24), then scaled back by both scales.
All arithmetic is float32.  Nothing here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full_like(x, d)


def quantize(x: torch.Tensor, qmax: int, dim: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), qmax)
    return torch.round(x / scale).clamp_(-qmax, qmax), scale


def qdense(x: torch.Tensor, w: torch.Tensor, qmax: int) -> torch.Tensor:
    qx, sx = quantize(x, qmax, dim=-1)
    qw, sw = quantize(w, qmax, dim=0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = qx @ qw
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc * sx * sw


def im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    B, H, W, C = x.shape
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, i:i + H:stride, j:j + W:stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)[:, :H // stride, :W // stride, :]


def logits(layers: list, params: dict, images: torch.Tensor, *,
           bits: int) -> torch.Tensor:
    """images (B, H, W, C) f32 -> (B, classes) f32."""
    qmax = (1 << (bits - 1)) - 1
    x = images.to(torch.float32)
    for i, layer in enumerate(layers):
        if layer[0] == "conv":
            _, c_out, k, stride = layer
            cols = im2col(x, k, stride)
            B, Ho, Wo, Fi = cols.shape
            y = qdense(cols.reshape(-1, Fi), params[f"l{i}"]["w"], qmax)
            x = torch.relu(y.reshape(B, Ho, Wo, c_out)
                           + params[f"l{i}"]["b"])
        elif layer[0] == "pool":
            k = layer[1]
            B, H, W, C = x.shape
            x = x.reshape(B, H // k, k, W // k, k, C).amax(dim=(2, 4))
        else:
            y = qdense(x.reshape(x.shape[0], -1), params[f"l{i}"]["w"],
                       qmax) + params[f"l{i}"]["b"]
            x = y if i == len(layers) - 1 else torch.relu(y)
    return x
