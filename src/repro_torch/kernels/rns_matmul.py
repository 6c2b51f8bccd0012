"""C-channel residue matmul with lazy reduction: Hopper kernel and plain version.

Replaces the TPU kernel ``repro/kernels/rns_matmul.py::rns_matmul_pallas``
(body ``_kernel``): per channel ``c``, ``center((A_c @ B_c) mod m_c)`` of
int8 centered residues, with no reduction inside the K loop.

* :func:`rns_matmul_cuda` launches ``csrc/rns_matmul.cu`` (int8 tensor
  cores through ``mma.sync.m16n8k32``; the planes keep N contiguous, so
  their bytes are transposed in registers with ``__byte_perm``).  Two
  schedules, picked by M in the C entry: up to 16 rows the decode
  schedule (weights on the mma's 16-row side, K cut stream-K across one
  block an SM, cut tiles combined in a per-device workspace that every
  launch leaves zero), above it the prefill schedule (128 x 256 tiles fed
  by a 4-stage ``cp.async`` ring).
  On the H100 it is bound by the weight-plane bytes at decode (M = 8) and
  by int8 tensor-core operations at prefill (M = 2048); see the source's
  note and ``csrc/rns_tiles.cuh``.
* :func:`rns_matmul_ref` is its plain PyTorch version: a float64 matmul per
  channel, exact because ``|acc| <= 64 * 64 * K < 2**53``, then the same
  truncating rem (``torch.fmod``), canonicalization and centering.

Both take strided views: a K segment of ``(C, M, K)`` and ``(C, K, N)`` is
passed as it lies in memory, so no operand is padded or copied per call.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

__all__ = ["rns_matmul_cuda", "rns_matmul_ref", "launches",
           "reset_launches"]

launches = 0
# the decode schedule's workspace, per (device, stream): zeroed once when it
# is allocated or grown; every launch leaves it zero
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    global launches
    launches = 0


def _workspace(device: torch.device, stream: int,
               nbytes: int) -> torch.Tensor | None:
    if nbytes == 0:
        return None
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        _workspaces[key] = ws
    return ws


def _center_rem(acc: torch.Tensor, m: int) -> torch.Tensor:
    r = torch.fmod(acc, m)                     # truncating, like lax.rem
    r = torch.where(r < 0, r + m, r)
    return torch.where(r > m // 2, r - m, r)


def rns_matmul_ref(a_res: torch.Tensor, b_res: torch.Tensor,
                   moduli: Sequence[int]) -> torch.Tensor:
    """(C, M, K) x (C, K, N) residues -> (C, M, N) int32 centered residues."""
    outs = []
    for c, m in enumerate(moduli):
        acc = torch.matmul(a_res[c].to(torch.float64),
                           b_res[c].to(torch.float64)).to(torch.int32)
        outs.append(_center_rem(acc, int(m)))
    return torch.stack(outs, dim=0)


def rns_matmul_cuda(a_res: torch.Tensor, b_res: torch.Tensor,
                    moduli: Sequence[int]) -> torch.Tensor:
    """The Hopper kernel; same contract as :func:`rns_matmul_ref`."""
    global launches
    if not (a_res.is_cuda and b_res.is_cuda):
        raise ValueError("rns_matmul_cuda takes CUDA tensors")
    if a_res.device != b_res.device:
        raise ValueError(f"operands on {a_res.device} and {b_res.device}")
    if a_res.dtype != torch.int8 or b_res.dtype != torch.int8:
        raise TypeError(f"rns_matmul_cuda takes int8 planes, got "
                        f"{a_res.dtype} and {b_res.dtype}")
    if a_res.dim() != 3 or b_res.dim() != 3:
        raise ValueError("rns_matmul_cuda takes (C, M, K) and (C, K, N)")
    C, M, K = a_res.shape
    C2, K2, N = b_res.shape
    if C2 != C or K2 != K or len(moduli) != C:
        raise ValueError(f"shape mismatch: {tuple(a_res.shape)} x "
                         f"{tuple(b_res.shape)} with {len(moduli)} moduli")
    if a_res.stride(2) != 1 or b_res.stride(2) != 1:
        raise ValueError("the innermost axis of both operands must be "
                         "contiguous")
    out = torch.empty((C, M, N), dtype=torch.int32, device=a_res.device)
    if M == 0 or N == 0:
        return out
    lib = build.library()
    mods = (ctypes.c_int * C)(*(int(m) for m in moduli))
    stream = torch.cuda.current_stream(a_res.device).cuda_stream
    nbytes = lib.rns_matmul_workspace(C, M, N, K)
    ws = _workspace(a_res.device, stream, nbytes)
    err = lib.rns_matmul_s8(
        a_res.data_ptr(), b_res.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), nbytes, mods, C, M, N, K,
        a_res.stride(0), a_res.stride(1), b_res.stride(0), b_res.stride(1),
        stream)
    build.check(err, "rns_matmul_s8")
    launches += 1
    return out
