"""Batched carry-free SD addition: Hopper kernel B8 and its plain version.

Replaces the TPU kernel ``repro/kernels/sd_add.py::sd_add_pallas``: two
``(B, n)`` int8 digit tensors (LSB first) add with the two-step rule, the
end-around transfer of ``kind`` (``"pow2m1"`` / ``"pow2"`` / ``"pow2p1"``),
or for ``"plain"`` no wrap and the transfer out kept as digit n
(``(B, n + 1)`` out).

* :func:`sd_add_cuda` launches ``csrc/sd_add.cu``: a block stages a tile of
  1024 vectors through shared memory with 16-byte copies, and each thread
  adds four vectors at once on packed (nonzero, sign) masks
  (``csrc/sd_add_tiles.cuh``).  The reference pads the digit axis to 128
  lanes; here the vectors stay n bytes, at any base address (a view on a
  storage offset).  Bound by bytes on the H100.
* :func:`sd_add_ref` is the plain version, a port of
  ``repro/kernels/ref.py::sd_add_ref`` (``sd.carry_free_add`` for
  ``"plain"``, else ``sdrns.modular_add``).
"""
from __future__ import annotations

import torch

from repro_torch.core import sd, sdrns
from repro_torch.kernels import build

__all__ = ["KINDS", "sd_add_cuda", "sd_add_ref", "sd_add_meta", "launches",
           "reset_launches"]

KINDS = ("pow2m1", "pow2", "pow2p1", "plain")
_KIND_CODE = {"pow2m1": 1, "pow2": 0, "pow2p1": -1, "plain": 2}
MAX_DIGITS = 16

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def sd_add_ref(x: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """(..., n) digits x 2 -> (..., n) digits ((..., n + 1) for plain)."""
    _check_kind(kind)
    if kind == "plain":
        return sd.carry_free_add(x, y)
    return sdrns.modular_add(x, y, kind)


def sd_add_meta(x: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """The contract's output shape, empty (the meta device)."""
    _check_kind(kind)
    n = x.shape[-1] + (1 if kind == "plain" else 0)
    return torch.empty((*x.shape[:-1], n), dtype=torch.int8, device=x.device)


def sd_add_cuda(x: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """The Hopper kernel; same contract as :func:`sd_add_ref`."""
    global launches
    _check_kind(kind)
    if not (x.is_cuda and y.is_cuda):
        raise ValueError("sd_add_cuda takes CUDA tensors")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if x.dtype != torch.int8 or y.dtype != torch.int8:
        raise TypeError(f"sd_add_cuda takes int8 digits, got {x.dtype} and "
                        f"{y.dtype}")
    if x.shape != y.shape or x.dim() < 1:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    n = x.shape[-1]
    if not 1 <= n <= MAX_DIGITS:
        raise ValueError(f"sd_add_cuda takes 1..{MAX_DIGITS} digits, got {n}")
    out_n = n + 1 if kind == "plain" else n
    out = torch.empty((*x.shape[:-1], out_n), dtype=torch.int8,
                      device=x.device)
    B = x.numel() // n
    if B == 0:
        return out
    xc, yc = x.contiguous(), y.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().sd_add_s8(xc.data_ptr(), yc.data_ptr(),
                                    out.data_ptr(), B, n, _KIND_CODE[kind],
                                    stream)
    build.check(err, "sd_add_s8")
    launches += 1
    return out
