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

The port also serves configurations the reference has no counterpart of
(:data:`PORT_ARCH_IDS`, resolved by the same :func:`get_config`): their
fields live on :class:`MlaMoeConfig`, a subclass, so ``ArchConfig`` stays
the reference's copy.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator

__all__ = ["ArchConfig", "MlaMoeConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
           "PORT_ARCH_IDS", "get_config", "is_mla", "cells_for", "all_cells"]


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
class MlaMoeConfig(ArchConfig):
    """A DeepSeek-V3-style decoder (the port's own; the reference has none):
    multi-head latent attention and sigmoid-routed experts with shared
    experts after ``first_dense`` leading dense layers.

    Attention: q maps ``d_model`` to ``n_heads x head_dim`` (``head_dim =
    qk_nope_dim + qk_rope_dim``; no query LoRA); ``kv_a`` maps it to the
    latent ``c_kv`` (``kv_lora_rank``, RMS-normed) and one rotary key
    ``k_pe`` (``qk_rope_dim``) shared by every head; ``kv_b`` maps the
    normed latent to each head's ``k_nope`` and value (``v_head_dim``).
    Rotary positions cover the rope parts alone, in DeepSeek-V3's pairing.
    The cache holds the normed latent and the roped ``k_pe`` a token.

    Experts: ``n_experts`` routed SwiGLUs of width ``d_ff``, ``top_k`` a
    token chosen on sigmoid scores plus a per-expert correction bias, the
    chosen scores normalised and scaled by ``routed_scale``; ``n_shared``
    shared experts, one SwiGLU of ``n_shared * d_ff``, see every token.
    The leading layers are dense SwiGLUs of ``dense_d_ff``.
    """

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    first_dense: int = 1
    dense_d_ff: int = 11264
    n_shared: int = 2
    routed_scale: float = 2.446

    def reduced(self) -> "MlaMoeConfig":
        """A tiny config of the same kinds of layers: one dense layer and
        two expert layers, 8 experts of which 3 a token."""
        return dataclasses.replace(
            self, n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=32,
            vocab=512, head_dim=24, kv_lora_rank=32, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16, dense_d_ff=96, n_experts=8,
            top_k=3, moe_cf=8.0, compute_dtype="float32", remat=False)


def is_mla(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` is a latent-attention decoder (:class:`MlaMoeConfig`)."""
    return isinstance(cfg, MlaMoeConfig)


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

# the port's own configurations, which the reference does not have
PORT_ARCH_IDS: tuple[str, ...] = (
    "moonlight-16b-a3b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_")
            for a in ARCH_IDS + PORT_ARCH_IDS}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
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
