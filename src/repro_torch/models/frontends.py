"""Modality front-end stand-ins (port of models/frontends.py).

The audio (whisper) and vlm (pixtral) families take *precomputed* frame and
patch embeddings: whisper's conv and log-mel stack and pixtral's ViT are
not part of the system.  These helpers draw synthetic embeddings from an
explicit ``torch.Generator`` for smoke runs and examples, and the
matching empty tensors on the ``meta`` device (the counterpart of the
reference's ``ShapeDtypeStruct``s) for the dry run.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["synthetic_frames", "synthetic_patches", "frames_struct",
           "patches_struct"]


def synthetic_frames(gen: torch.Generator, batch: int, n_frames: int,
                     cfg: ArchConfig) -> torch.Tensor:
    """Stand-in for the conv stack's output: (B, n_frames, d_model) f32."""
    return torch.randn(batch, n_frames, cfg.d_model, generator=gen,
                       device=gen.device) * 0.1


def synthetic_patches(gen: torch.Generator, batch: int,
                      cfg: ArchConfig) -> torch.Tensor:
    """Stand-in for the ViT's patch embeddings: (B, n_img_tokens, d_model)
    f32."""
    return torch.randn(batch, cfg.n_img_tokens, cfg.d_model, generator=gen,
                       device=gen.device) * 0.1


# the dtype of the embeddings the dry run feeds the model
STRUCT_DTYPE = torch.bfloat16


def frames_struct(batch: int, n_frames: int, cfg: ArchConfig
                  ) -> torch.Tensor:
    """(B, n_frames, d_model) bf16 on the meta device: shape and dtype
    only."""
    return torch.empty((batch, n_frames, cfg.d_model), dtype=STRUCT_DTYPE,
                       device="meta")


def patches_struct(batch: int, cfg: ArchConfig) -> torch.Tensor:
    """(B, n_img_tokens, d_model) bf16 on the meta device."""
    return torch.empty((batch, cfg.n_img_tokens, cfg.d_model),
                       dtype=STRUCT_DTYPE, device="meta")
