"""Kernel-implementation registry for the numerics dispatch surface.

Every op registers two implementations:

* ``"cuda"`` -- the hand-written Hopper kernel (``kernels/``, built from
  ``csrc/``);
* ``"ref"``  -- its plain PyTorch version, for tensors on the CPU.

The choice follows the device of the tensor the op is given, never a global
switch: a CUDA tensor always reaches the kernel (which launches or raises),
a CPU tensor always reaches the plain version.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["BACKENDS", "backend_for", "register_impl", "get_impl"]

BACKENDS = ("cuda", "ref")

_REGISTRY: dict[str, dict[str, Callable]] = {}


def backend_for(device: torch.device | str) -> str:
    """``"cuda"`` for a CUDA device, ``"ref"`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "ref"
    raise ValueError(f"no numerics backend for device {device!r}")


def register_impl(op: str, backend: str, fn: Callable) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    _REGISTRY.setdefault(op, {})[backend] = fn


def get_impl(op: str, device: torch.device | str) -> Callable:
    """The implementation of ``op`` for tensors on ``device``."""
    impls = _REGISTRY.get(op)
    if impls is None:
        raise KeyError(f"no backends registered for op {op!r}")
    return impls[backend_for(device)]
