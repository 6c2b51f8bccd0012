"""Architecture configuration (a copy of ``repro.configs.base.ArchConfig``).

The port keeps its own copy so that it imports nothing of the JAX package.
``ArchConfig`` and its ``reduced()`` are kept field for field and value for
value, and so are the shape cells (``ShapeConfig``, ``SHAPES``,
``cells_for``, ``all_cells``) the dry run iterates: the parity tests build the same reduced model in both packages and
load the same committed checkpoint into each.  Every architecture of the
reference is ported: the dense ``qwen3-8b``, ``yi-6b``, ``phi3-medium-14b``
and ``granite-20b``, the hybrid ``zamba2-7b``, the ssm ``mamba2-780m``, the
moe ``moonshot-v1-16b-a3b`` and ``grok-1-314b``, the audio (encoder-decoder)
``whisper-small`` and the vlm ``pixtral-12b``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "cells_for", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    qk_norm: bool = False
    mlp_type: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_cf: float = 1.25     # capacity factor (reduced() raises it so the
                             # serving-consistency tests are drop-free)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): shared attn+mlp block applied after every k-th layer
    attn_every: int = 0
    # enc-dec (whisper): n_layers = decoder depth, n_enc_layers = encoder
    n_enc_layers: int = 0
    dec_len: int = 448       # decoder target length for enc-dec train/prefill
    # vlm (pixtral): patches prepended by the stub frontend
    n_img_tokens: int = 0
    # numerics / schedule
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"     # grok-314B stores bf16 (16 GiB budget)
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    matmul_out_dtype: str = "compute"  # "compute" | "float32" (measured
                                       # per-arch; see models/linear.py)
    remat: bool = True
    sub_quadratic: bool = False
    tie_embeddings: bool = True
    # training-loop defaults (launch/train.py may override)
    microbatch: int = 0      # 0 -> no grad accumulation

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = {
            "n_layers": 4 if self.family == "hybrid" else 2,
            "d_model": 64,
            "n_heads": 4,
            "n_kv": max(1, min(self.n_kv, 4) if self.n_kv < self.n_heads
                        else 4),
            "d_ff": 96 if self.n_experts == 0 else 48,
            "vocab": 512,
            "head_dim": 16,
            "compute_dtype": "float32",
            "remat": False,
        }
        if self.n_experts:
            r["n_experts"] = 4
            r["top_k"] = 2
            r["moe_cf"] = 8.0
        if self.ssm_state:
            r["ssm_state"] = 16
            r["ssm_headdim"] = 16
            r["ssm_chunk"] = 8
        if self.attn_every:
            r["attn_every"] = 2
        if self.n_enc_layers:
            r["n_enc_layers"] = 2
            r["dec_len"] = 16
        if self.n_img_tokens:
            r["n_img_tokens"] = 8
        return dataclasses.replace(self, **r)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: tuple[str, ...] = (
    "zamba2-7b",
    "granite-20b",
    "qwen3-8b",
    "yi-6b",
    "phi3-medium-14b",
    "whisper-small",
    "pixtral-12b",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "mamba2-780m",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).get_config()


def cells_for(arch: str) -> list[tuple[str, str, bool, str]]:
    """(arch, shape, runnable, skip_reason) for each of the arch's 4 cells."""
    cfg = get_config(arch)
    out = []
    for shape in SHAPES:
        if shape == "long_500k" and not cfg.sub_quadratic:
            out.append((arch, shape, False,
                        "full quadratic attention at 524288 — skipped per "
                        "assignment (sub-quadratic archs only)"))
        else:
            out.append((arch, shape, True, ""))
    return out


def all_cells() -> Iterator[tuple[str, str, bool, str]]:
    for a in ARCH_IDS:
        yield from cells_for(a)
