"""Fused SD-RNS modular matmul: Hopper kernels B6 and B7, and their plain
version.

Replaces the TPU kernels ``repro/kernels/sdrns_matmul.py``:
``sdrns_matmul_pallas`` (B6, grid ``(C, M/bm, N/bn)``) and
``sdrns_matvec_pallas`` (B7, the decode schedule, M <= 8 kept whole).  Per
channel, ``(C, M, K, n) x (C, K, N, n)`` int8 SD digits (LSB first) ->
``(C, M, N, n)`` int8 digits of ``(A_c @ B_c) mod m_c``: every term is the
Eq. 2 product (rotations of a's digits selected by b's digits, a pairwise
end-around adder tree), and the K terms reduce by the same pairwise tree,
so the output digit vectors (not only their values) are the reference's.

* :func:`sdrns_matmul_cuda` / :func:`sdrns_matvec_cuda` launch
  ``csrc/sdrns_matmul.cu``: one body on packed digit masks, two
  schedules (rows tiled by 4, or all M <= 8 rows a block so each B digit
  vector is read once), K split into chunks of 64 leaves whose roots a
  second launch joins; the wrapper allocates the roots workspace.  They
  are bound by the integer instruction rate of the CUDA cores, far above
  both the planes' byte bound and the int8 tensor-core bound; see the
  source's note.
* :func:`sdrns_matmul_ref` is the plain version, a port of
  ``repro/kernels/ref.py::sdrns_matmul_ref``: per channel
  ``sdrns.modular_mul`` over the broadcast ``(M, K, N)`` terms, then the
  pairwise tree over K.  It materializes the ``(n, M, K, N, n)`` partial
  products, so it runs column block by column block (columns are
  independent: the same digits).

``wrap_signs`` are the channels' end-around signs (``core.sdrns.WRAP_SIGNS``:
+1 for 2^n - 1, 0 for 2^n, -1 for 2^n + 1).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core import sd, sdrns
from repro_torch.kernels import build

__all__ = ["sdrns_matmul_cuda", "sdrns_matvec_cuda", "sdrns_matmul_ref",
           "sdrns_matmul_meta",
           "MATVEC_MAX_M", "launches", "reset_launches"]

MATVEC_MAX_M = 8
DIGIT_WIDTHS = (5, 7)          # widths the kernel is built for
_KIND_OF = {ws: kind for kind, ws in sdrns.WRAP_SIGNS.items()}
# partial-product elements the plain version holds per column block
_PLAIN_BUDGET = 1 << 26

launches = {"sdrns_matmul": 0, "sdrns_matvec": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def sdrns_matmul_ref(a_dig: torch.Tensor, b_dig: torch.Tensor,
                     wrap_signs: Sequence[int]) -> torch.Tensor:
    """(C, M, K, n) x (C, K, N, n) digits -> (C, M, N, n) int8 digits."""
    C, M, K, n = a_dig.shape
    N = b_dig.shape[2]
    cols = max(1, _PLAIN_BUDGET // max(1, n * M * K * n))
    outs = []
    for c, ws in enumerate(wrap_signs):
        kind = _KIND_OF[int(ws)]
        blocks = []
        for j0 in range(0, N, cols):
            prod = sdrns.modular_mul(a_dig[c][:, :, None, :],
                                     b_dig[c][None, :, j0:j0 + cols, :], kind)
            blocks.append(sd.pairwise_reduce(
                prod, 1, lambda x, y: sdrns.modular_add(x, y, kind)))
        outs.append(torch.cat(blocks, dim=1) if blocks else
                    a_dig.new_zeros((M, 0, n)))
    return torch.stack(outs)


def sdrns_matmul_meta(a_dig: torch.Tensor, b_dig: torch.Tensor,
                      wrap_signs: Sequence[int]) -> torch.Tensor:
    """The contract's (C, M, N, n) int8 digits, empty (the meta device):
    no partial-product stack is built."""
    C, M, _, n = a_dig.shape
    return torch.empty((C, M, b_dig.shape[2], n), dtype=torch.int8,
                       device=a_dig.device)


def _launch(a_dig: torch.Tensor, b_dig: torch.Tensor,
            wrap_signs: Sequence[int], matvec: bool) -> torch.Tensor:
    name = "sdrns_matvec" if matvec else "sdrns_matmul"
    if not (a_dig.is_cuda and b_dig.is_cuda):
        raise ValueError(f"{name}_cuda takes CUDA tensors")
    if a_dig.device != b_dig.device:
        raise ValueError(f"operands on {a_dig.device} and {b_dig.device}")
    if a_dig.dtype != torch.int8 or b_dig.dtype != torch.int8:
        raise TypeError(f"{name}_cuda takes int8 digits, got {a_dig.dtype} "
                        f"and {b_dig.dtype}")
    if a_dig.dim() != 4 or b_dig.dim() != 4:
        raise ValueError(f"{name}_cuda takes (C, M, K, n) and (C, K, N, n)")
    C, M, K, n = a_dig.shape
    C2, K2, N, n2 = b_dig.shape
    if (C2, K2, n2) != (C, K, n) or len(wrap_signs) != C:
        raise ValueError(f"shape mismatch: {tuple(a_dig.shape)} x "
                         f"{tuple(b_dig.shape)} with {len(wrap_signs)} signs")
    if n not in DIGIT_WIDTHS:
        raise ValueError(f"{name}_cuda is built for digit widths "
                         f"{DIGIT_WIDTHS}, got {n}")
    if matvec and M > MATVEC_MAX_M:
        raise ValueError(f"sdrns_matvec_cuda takes M <= {MATVEC_MAX_M}, "
                         f"got {M}")
    if K > 1 << 20:
        raise ValueError(f"{name}_cuda takes K <= 2**20, got {K}")
    if (a_dig.stride(3), a_dig.stride(2)) != (1, n) or \
            (b_dig.stride(3), b_dig.stride(2)) != (1, n):
        raise ValueError("each operand's last two axes must be contiguous")
    out = torch.empty((C, M, N, n), dtype=torch.int8, device=a_dig.device)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    lib = build.library()
    roots = torch.empty(lib.sdrns_matmul_workspace(C, M, N, K, int(matvec)),
                        dtype=torch.uint8, device=a_dig.device)
    signs = (ctypes.c_int * C)(*(int(w) for w in wrap_signs))
    stream = torch.cuda.current_stream(a_dig.device).cuda_stream
    err = lib.sdrns_matmul_s8(
        a_dig.data_ptr(), b_dig.data_ptr(), out.data_ptr(), roots.data_ptr(),
        signs, C, M, N, K, n, a_dig.stride(0), a_dig.stride(1),
        b_dig.stride(0), b_dig.stride(1), int(matvec), stream)
    build.check(err, "sdrns_matmul_s8")
    launches[name] += 1
    return out


def sdrns_matmul_cuda(a_dig: torch.Tensor, b_dig: torch.Tensor,
                      wrap_signs: Sequence[int]) -> torch.Tensor:
    """Kernel B6 (rows tiled by 4); same contract as
    :func:`sdrns_matmul_ref`."""
    return _launch(a_dig, b_dig, wrap_signs, matvec=False)


def sdrns_matvec_cuda(a_dig: torch.Tensor, b_dig: torch.Tensor,
                      wrap_signs: Sequence[int]) -> torch.Tensor:
    """Kernel B7 (M <= 8, every row in one block); same contract as
    :func:`sdrns_matmul_ref`."""
    return _launch(a_dig, b_dig, wrap_signs, matvec=True)
