"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module keeps a launch counter that its CUDA wrapper bumps once
per kernel launch (and nowhere else), so a run can show that its main path
went through the kernels.  :func:`launch_counts` gathers those of B1-B9;
the reverse conversion after B1 (B9, ``rns_decode``) follows B1's launches
one for one wherever the rns runner decodes without the witness check.
"""
from __future__ import annotations

from repro_torch.kernels import (flash_attn, rns_decode, rns_matmul, sd_add,
                                 sdrns_matmul)

__all__ = ["launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"rns_matmul": rns_matmul.launches, **flash_attn.launches,
            **sdrns_matmul.launches, "sd_add": sd_add.launches,
            "rns_decode": rns_decode.launches}


def reset_launch_counts() -> None:
    rns_matmul.reset_launches()
    flash_attn.reset_launches()
    sdrns_matmul.reset_launches()
    sd_add.reset_launches()
    rns_decode.reset_launches()
