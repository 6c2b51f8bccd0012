"""Feed-forward blocks, SwiGLU and GELU (port of models/mlp.py)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import linear

__all__ = ["init_swiglu", "swiglu", "init_gelu_mlp", "gelu_mlp"]


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


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  device="cuda") -> dict[str, Any]:
    return {
        "w_up": linear.init_dense(gen, d_model, d_ff, device),
        "w_down": linear.init_dense(gen, d_ff, d_model, device),
    }


def gelu_mlp(params: dict[str, Any], x: torch.Tensor,
             dense_kw: dict[str, Any] | None = None) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; torch's is the
    exact erf, so the approximation is asked for by name."""
    dense_kw = dense_kw or {}
    h = linear.dense(params["w_up"], x, **dense_kw)
    h = torch.nn.functional.gelu(h.to(torch.float32),
                                 approximate="tanh").to(h.dtype)
    return linear.dense(params["w_down"], h, **dense_kw)
