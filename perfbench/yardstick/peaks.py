"""NVIDIA H100 SXM5 80 GB peaks (NVIDIA's data sheet, SXM5 column, dense
rates without sparsity, at the 700 W power limit).  A card set below
700 W runs slower under load; the harness prints the card's power limit
beside every result."""
from __future__ import annotations

PEAK_OPS_INT8 = 1979e12       # int8 tensor-core ops/s
PEAK_FLOPS_BF16 = 989e12      # bf16 tensor-core FLOP/s
PEAK_FLOPS_TF32 = 495e12      # tf32 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12        # f32 FLOP/s on the CUDA cores
HBM_BW = 3.35e12              # HBM3 bytes/s

PEAK = {"int8": PEAK_OPS_INT8, "bf16": PEAK_FLOPS_BF16,
        "tf32": PEAK_FLOPS_TF32, "f32": PEAK_FLOPS_F32}


def least_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of the operations at
    the kind's peak and the bytes at the HBM rate."""
    return max(ops / PEAK[kind], nbytes / HBM_BW)
