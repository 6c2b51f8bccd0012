"""Reverse conversion of B1's residues: Hopper kernel B9 and its plain version.

Replaces no TPU kernel: the reference decodes the residue matmul's output
with ``jnp`` ops (``repro/core/moduli.py::ModuliSet.from_residues``).  The
contract is that function's, with the segment sum folded in: ``res``
``(C', M, N)`` or ``(S, C', M, N)`` int32 residues (any representative;
the first C channels are decoded, C' >= C) -> ``(M, N)`` / ``(S, M, N)``
int32 values, or, with ``out``, the values added into ``out`` in place
(int32, wrapping) and ``out`` returned.

* :func:`rns_decode_cuda` launches ``csrc/rns_decode.cu``: each element
  decoded in registers (stepwise mixed-radix conversion, the sign test,
  the value modulo 2^32) from 16-byte loads of each channel plane, read
  through the channel and stack strides B1's output has, so nothing is
  copied.  Bound by bytes on the H100 (4 C in and 4 out an element).
* :func:`rns_decode_ref` is its plain version: ``from_residues`` and an
  eager add.
* :func:`decode_tables` gives the constants the kernel takes, computed once
  a moduli set and passed by value (no copy to the device, no sync).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.moduli import ModuliSet, modinv
from repro_torch.kernels import build

__all__ = ["MAX_CHANNELS", "MAX_MODULUS", "supports", "DecodeTables",
           "decode_tables", "rns_decode_cuda", "rns_decode_ref",
           "rns_decode_meta", "launches", "reset_launches"]

MAX_CHANNELS = 8
MAX_MODULUS = 46340         # from_residues' own limit

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def supports(mset: ModuliSet) -> bool:
    """Whether the kernel decodes ``mset`` (no witness channels: a
    redundant set passes its ``info``)."""
    return (mset.redundant == 0 and mset.num_channels <= MAX_CHANNELS
            and max(mset.moduli) <= MAX_MODULUS)


@dataclasses.dataclass(frozen=True)
class DecodeTables:
    """The kernel's constants for one moduli set, as ``csrc/rns_decode.cu``'s
    ``Tables`` names them, each padded to MAX_CHANNELS: ``m``,
    ``magic`` (floor(2^32 / m)), ``off`` (2^31 mod m), ``inv`` / ``ninv``
    (``inv[i][j]`` = m_i^-1 mod m_j for i < j, ``ninv`` = m_j - inv),
    ``half`` (the mixed-radix digits of (M - 1) / 2), ``prod`` (m_0 ...
    m_{j-1} mod 2^32) and ``big_m`` (M mod 2^32)."""

    m: tuple[int, ...]
    magic: tuple[int, ...]
    off: tuple[int, ...]
    inv: tuple[tuple[int, ...], ...]
    ninv: tuple[tuple[int, ...], ...]
    half: tuple[int, ...]
    prod: tuple[int, ...]
    big_m: int

    def words(self) -> list[int]:
        """The uint32 words of ``Tables``, in its order."""
        return [*self.m, *self.magic, *self.off,
                *(w for row in self.inv for w in row),
                *(w for row in self.ninv for w in row),
                *self.half, *self.prod, self.big_m]


@functools.lru_cache(maxsize=None)
def decode_tables(moduli: tuple[int, ...]) -> DecodeTables:
    """:class:`DecodeTables` of ``moduli`` (computed once a set)."""
    mset = ModuliSet(tuple(moduli))
    C = len(moduli)
    inv = [[0] * MAX_CHANNELS for _ in range(MAX_CHANNELS)]
    ninv = [[0] * MAX_CHANNELS for _ in range(MAX_CHANNELS)]
    for i in range(C):
        for j in range(i + 1, C):
            inv[i][j] = modinv(moduli[i] % moduli[j], moduli[j])
            ninv[i][j] = moduli[j] - inv[i][j]
    prod, p = [], 1
    for m in moduli:
        prod.append(p % 2**32)
        p *= m
    pad = (0,) * (MAX_CHANNELS - C)
    return DecodeTables(
        m=tuple(moduli) + pad,
        magic=tuple(2**32 // m for m in moduli) + pad,
        off=tuple(2**31 % m for m in moduli) + pad,
        inv=tuple(map(tuple, inv)), ninv=tuple(map(tuple, ninv)),
        half=mset._half_mrc_digits + pad, prod=tuple(prod) + pad,
        big_m=mset.M % 2**32)


@functools.lru_cache(maxsize=None)
def _table_words(moduli: tuple[int, ...]) -> ctypes.Array:
    words = decode_tables(moduli).words()
    return (ctypes.c_uint32 * len(words))(*words)


def _out_shape(res: torch.Tensor, mset: ModuliSet,
               out: torch.Tensor | None) -> tuple[int, ...]:
    """Check the contract (module docstring); the output's shape."""
    if not supports(mset):
        raise ValueError(f"rns_decode takes up to {MAX_CHANNELS} moduli <= "
                         f"{MAX_MODULUS} and no witness channels, got "
                         f"{mset.moduli} (redundant={mset.redundant})")
    if res.dtype != torch.int32:
        raise TypeError(f"rns_decode takes int32 residues, got {res.dtype}")
    if res.dim() not in (3, 4) or res.shape[-3] < mset.num_channels:
        raise ValueError(f"rns_decode takes (C, M, N) or (S, C, M, N) "
                         f"residues with C >= {mset.num_channels}, got "
                         f"{tuple(res.shape)}")
    shape = (*res.shape[:-3], *res.shape[-2:])
    if out is not None:
        if out.dtype != torch.int32 or tuple(out.shape) != shape:
            raise ValueError(f"out must be int32 {shape}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        if out.device != res.device:
            raise ValueError(f"residues on {res.device}, out on "
                             f"{out.device}")
    return shape


def rns_decode_ref(res: torch.Tensor, mset: ModuliSet,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """``mset.from_residues`` over the first C channels, added into ``out``
    where one is given."""
    _out_shape(res, mset, out)
    part = mset.from_residues(
        res.narrow(-3, 0, mset.num_channels).movedim(-3, 0))
    return part if out is None else out.add_(part)


def rns_decode_meta(res: torch.Tensor, mset: ModuliSet,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The contract's output, empty (the meta device)."""
    shape = _out_shape(res, mset, out)
    if out is not None:
        return out
    return torch.empty(shape, dtype=torch.int32, device=res.device)


def rns_decode_cuda(res: torch.Tensor, mset: ModuliSet,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The Hopper kernel; same contract as :func:`rns_decode_ref`."""
    global launches
    shape = _out_shape(res, mset, out)
    if not res.is_cuda:
        raise ValueError("rns_decode_cuda takes CUDA tensors")
    M, N = res.shape[-2:]
    if N > 1 and res.stride(-1) != 1 or M > 1 and res.stride(-2) != N:
        raise ValueError(f"rns_decode_cuda takes contiguous (M, N) planes, "
                         f"got strides {res.stride()}")
    if out is not None and not out.is_contiguous():
        raise ValueError("rns_decode_cuda adds into a contiguous out")
    acc = out is not None
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=res.device)
    S = res.shape[0] if res.dim() == 4 else 1
    if S == 0 or M == 0 or N == 0:
        return out
    ss = res.stride(0) if res.dim() == 4 else 0
    stream = torch.cuda.current_stream(res.device).cuda_stream
    err = build.library().rns_decode_s32(
        res.data_ptr(), out.data_ptr(), _table_words(mset.moduli),
        mset.num_channels, S, M * N, res.stride(-3), ss, int(acc), stream)
    build.check(err, "rns_decode_s32")
    launches += 1
    return out
