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

Stack mode (the MoE expert einsums): ``(S, C, M, K) x (S, C, K, N) ->
(S, C, M, N)``, S independent products in one launch.  The kernel folds
the stack into its channel loop (folded channel ``f`` is slice ``f // C``
with modulus ``f % C``), so each slice is bit-identical to a launch of its
own; the plain version loops over the slices.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

__all__ = ["rns_matmul_cuda", "rns_matmul_ref", "rns_matmul_meta",
           "launches",
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
    """(C, M, K) x (C, K, N) residues -> (C, M, N) int32 centered residues;
    a stack ``(S, C, M, K) x (S, C, K, N) -> (S, C, M, N)`` slice by
    slice."""
    if a_res.dim() == 4:
        return torch.stack([rns_matmul_ref(a_res[s], b_res[s], moduli)
                            for s in range(a_res.shape[0])])
    outs = []
    for c, m in enumerate(moduli):
        acc = torch.matmul(a_res[c].to(torch.float64),
                           b_res[c].to(torch.float64)).to(torch.int32)
        outs.append(_center_rem(acc, int(m)))
    return torch.stack(outs, dim=0)


def rns_matmul_meta(a_res: torch.Tensor, b_res: torch.Tensor,
                    moduli: Sequence[int]) -> torch.Tensor:
    """The contract's output shape and dtype, empty (the meta device)."""
    return torch.empty((*a_res.shape[:-1], b_res.shape[-1]),
                       dtype=torch.int32, device=a_res.device)


def rns_matmul_cuda(a_res: torch.Tensor, b_res: torch.Tensor,
                    moduli: Sequence[int]) -> torch.Tensor:
    """The Hopper kernel; same contract as :func:`rns_matmul_ref`, one
    launch for a stack too."""
    global launches
    if not (a_res.is_cuda and b_res.is_cuda):
        raise ValueError("rns_matmul_cuda takes CUDA tensors")
    if a_res.device != b_res.device:
        raise ValueError(f"operands on {a_res.device} and {b_res.device}")
    if a_res.dtype != torch.int8 or b_res.dtype != torch.int8:
        raise TypeError(f"rns_matmul_cuda takes int8 planes (every "
                        f"modulus <= 256), got {a_res.dtype} and "
                        f"{b_res.dtype}: a wider moduli set (P24, P33, "
                        f"P64) has no residue matmul kernel")
    if a_res.dim() != b_res.dim() or a_res.dim() not in (3, 4):
        raise ValueError("rns_matmul_cuda takes (C, M, K) and (C, K, N), or "
                         "(S, C, M, K) and (S, C, K, N)")
    stacked = a_res.dim() == 4
    a4 = a_res if stacked else a_res.unsqueeze(0)
    b4 = b_res if stacked else b_res.unsqueeze(0)
    S, C, M, K = a4.shape
    S2, C2, K2, N = b4.shape
    if S2 != S or C2 != C or K2 != K or len(moduli) != C:
        raise ValueError(f"shape mismatch: {tuple(a_res.shape)} x "
                         f"{tuple(b_res.shape)} with {len(moduli)} moduli")
    if a4.stride(3) != 1 or b4.stride(3) != 1:
        raise ValueError("the innermost axis of both operands must be "
                         "contiguous")
    out = torch.empty((S, C, M, N), dtype=torch.int32, device=a_res.device)
    if not stacked:
        out = out[0]
    if S == 0 or M == 0 or N == 0:
        return out
    lib = build.library()
    mods = (ctypes.c_int * C)(*(int(m) for m in moduli))
    stream = torch.cuda.current_stream(a_res.device).cuda_stream
    nbytes = lib.rns_matmul_workspace(S * C, M, N, K)
    ws = _workspace(a_res.device, stream, nbytes)
    # one slice has no stack stride (it would only narrow the loads)
    a_ss, b_ss = (a4.stride(0), b4.stride(0)) if S > 1 else (0, 0)
    err = lib.rns_matmul_s8(
        a4.data_ptr(), b4.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), nbytes, mods, S, C, M, N, K,
        a_ss, a4.stride(1), a4.stride(2), b_ss, b4.stride(1), b4.stride(2),
        stream)
    build.check(err, "rns_matmul_s8")
    launches += 1
    return out
