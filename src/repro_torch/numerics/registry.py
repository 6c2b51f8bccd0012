"""Kernel-implementation registry for the numerics dispatch surface.

Every op registers three implementations:

* ``"cuda"`` -- the hand-written Hopper kernel (``kernels/``, built from
  ``csrc/``);
* ``"ref"``  -- its plain PyTorch version, for tensors on the CPU;
* ``"meta"`` -- empty outputs of the kernel's shapes and dtypes, for
  tensors on the meta device (the dry run, ``launch/dryrun.py``; the
  counterpart of the reference's ``"cost"`` backend, without its decoded
  values).

The choice follows the device of the tensor the op is given, never a global
switch: a CUDA tensor always reaches the kernel (which launches or raises),
a CPU tensor always reaches the plain version, a meta tensor the meta one.

While a work count is in use (``roofline/op_cost.py::OpCost``), it sits in
:data:`OBSERVER`, and :func:`get_impl` hands out the implementation
wrapped so that the count sees each call; otherwise it hands out the
implementation itself.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

__all__ = ["BACKENDS", "OBSERVER", "backend_for", "register_impl",
           "get_impl"]

BACKENDS = ("cuda", "ref", "meta")

_REGISTRY: dict[str, dict[str, Callable]] = {}
_BACKEND_OF = {"cuda": "cuda", "cpu": "ref", "meta": "meta"}

# the work count in use, or None: called as ``OBSERVER(op, impl, args,
# kwargs)`` in place of ``impl(*args, **kwargs)``
OBSERVER: Callable | None = None


def backend_for(device: torch.device | str) -> str:
    """``"cuda"`` for a CUDA device, ``"ref"`` for the CPU, ``"meta"`` for
    the meta device."""
    kind = torch.device(device).type
    if kind not in _BACKEND_OF:
        raise ValueError(f"no numerics backend for device {device!r}")
    return _BACKEND_OF[kind]


def register_impl(op: str, backend: str, fn: Callable) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    _REGISTRY.setdefault(op, {})[backend] = fn


def get_impl(op: str, device: torch.device | str) -> Callable:
    """The implementation of ``op`` for tensors on ``device`` (seen by the
    :data:`OBSERVER` when one is set)."""
    impls = _REGISTRY.get(op)
    if impls is None:
        raise KeyError(f"no backends registered for op {op!r}")
    fn = impls[backend_for(device)]
    if OBSERVER is None:
        return fn
    return functools.partial(OBSERVER, op, fn)
