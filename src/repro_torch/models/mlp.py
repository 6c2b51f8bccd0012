"""SwiGLU feed-forward block (port of models/mlp.py, swiglu only)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import linear

__all__ = ["init_swiglu", "swiglu"]


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                device="cuda") -> dict[str, Any]:
    return {
        "w_gate": linear.init_dense(gen, d_model, d_ff, device),
        "w_up": linear.init_dense(gen, d_model, d_ff, device),
        "w_down": linear.init_dense(gen, d_ff, d_model, device),
    }


def swiglu(params: dict[str, Any], x: torch.Tensor,
           dense_kw: dict[str, Any] | None = None) -> torch.Tensor:
    dense_kw = dense_kw or {}
    g = linear.dense(params["w_gate"], x, **dense_kw)
    u = linear.dense(params["w_up"], x, **dense_kw)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(u.dtype) * u
    return linear.dense(params["w_down"], h, **dense_kw)
