"""NVIDIA H100 SXM5 80 GB constants for the roofline model (per card).

Source: NVIDIA H100 Tensor Core GPU data sheet, the SXM5 column, dense
rates (without structured sparsity).  Every rate assumes the card runs at
its 700 W power limit: a card set below it runs slower under load, so a
measurement is read beside ``nvidia-smi``'s power limit.
"""
from __future__ import annotations

# operations (or FLOP) a second, dense, at 700 W (data sheet, SXM5)
PEAK_OPS_INT8 = 1979e12       # int8 tensor-core ops/s
PEAK_FLOPS_BF16 = 989e12      # bf16 tensor-core FLOP/s
PEAK_FLOPS_TF32 = 495e12      # tf32 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12        # f32 FLOP/s on the CUDA cores (no tensor core)
HBM_BW = 3.35e12              # HBM3 bytes/s (data sheet, SXM5)
HBM_BYTES = 80 * 10**9        # 80 GB of HBM3 (data sheet)
NVLINK_BW = 450e9             # bytes/s each direction (900 GB/s total)

# the peak of each kind of work the counter (roofline/op_cost.py) sums
PEAK = {"int8": PEAK_OPS_INT8, "bf16": PEAK_FLOPS_BF16,
        "tf32": PEAK_FLOPS_TF32, "f32": PEAK_FLOPS_F32}
