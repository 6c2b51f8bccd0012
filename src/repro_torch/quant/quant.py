"""Symmetric integer quantization (port of ``repro/quant/quant.py``).

``round(x / scale)`` rounds half to even and divides (a multiply by the
reciprocal breaks ties differently), exactly as the reference does.  Both
divisions run tensor by tensor: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which would move the card's scales one ulp
away from the CPU's (and the reference's).
"""
from __future__ import annotations

import torch

__all__ = ["qmax_for_bits", "quantize_symmetric", "dequantize",
           "true_divide"]


def qmax_for_bits(bits: int) -> int:
    """Symmetric range: int4 -> 7, int8 -> 127."""
    return (1 << (bits - 1)) - 1


def quantize_symmetric(x: torch.Tensor, bits: int, *,
                       axis: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to signed integers in [-qmax, qmax].

    Returns ``(q int32, scale f32)`` with ``scale`` broadcastable to ``x``
    (kept dims when ``axis`` is given, a scalar otherwise).
    """
    qmax = qmax_for_bits(bits)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = true_divide(torch.clamp(amax, min=1e-8), qmax)
    q = torch.round_(x / scale).clamp_(-qmax, qmax).to(torch.int32)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` with an IEEE division on every device (see module note)."""
    return x / torch.full_like(x, d)
