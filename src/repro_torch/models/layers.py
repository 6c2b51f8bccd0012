"""Shared building blocks: RMSNorm, RoPE, sinusoidal positions, embedding
(port of models/layers.py)."""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (ShardedParam, get_shard_ctx,
                                           shard_ctx)
from repro_torch.quant.quant import true_divide

__all__ = ["rmsnorm", "init_rmsnorm", "rope", "sinusoidal_positions",
           "init_embedding", "embed", "remat_call"]


def sinusoidal_positions(length: int, d: int, device="cuda") -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings, (length, d) f32, on the
    reference's timescale of 1e4."""
    half = d // 2
    freqs = torch.exp(true_divide(
        -torch.log(torch.tensor(1e4, dtype=torch.float32))
        * torch.arange(half, dtype=torch.float32), max(half - 1, 1))
    ).to(device)
    ang = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
           * freqs[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_rmsnorm(d: int, device="cuda") -> dict[str, torch.Tensor]:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params: dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """f32 variance; normalize and multiply in the input dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4, pairing: str = "half") -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, hd); positions: (B, S) or (S,).

    ``pairing="half"`` rotates dims ``i`` and ``i + hd/2`` together (every
    model of the reference).  ``"interleaved"`` is DeepSeek-V3's: dims
    ``2i`` and ``2i + 1`` are a pair, de-interleaved first (evens, then
    odds) and rotated as halves, so the output keeps that order, as the
    published model's ``apply_rotary_pos_emb`` does.  Frequency ``i`` is
    ``theta ** (-2i / hd)`` in both."""
    if pairing == "interleaved":
        x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    elif pairing != "half":
        raise ValueError(f"rope pairing must be 'half' or 'interleaved', "
                         f"got {pairing!r}")
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** true_divide(
        -torch.arange(0, half, dtype=torch.float32, device=x.device), half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs   # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   device="cuda") -> dict[str, torch.Tensor]:
    return {"table": torch.randn(vocab, d, generator=gen, device=device)
            * 0.02}


def embed(params: dict[str, torch.Tensor], tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table in the compute dtype.  Served, the rows are cast
    after the gather (the same values as casting the whole table first,
    without a table-sized temporary).  Trained, the table is cast first, as
    in the reference, so the gradient's scatter-add sums in the compute
    dtype as the reference's does, and the gather is ``F.embedding``, whose
    backward sums a row's gradients in a fixed order (an indexing
    backward's accumulating scatter does not on the CPU), so a step is
    reproducible bit for bit."""
    table = params["table"]
    if isinstance(table, ShardedParam):
        return _embed_sharded(table, tokens, compute_dtype)
    if torch.is_grad_enabled() and table.requires_grad:
        return torch.nn.functional.embedding(tokens, table.to(compute_dtype))
    return table[tokens].to(compute_dtype)


def _embed_sharded(table: ShardedParam, tokens: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    """The train step's lookup in a table of this rank's block: the FSDP
    split gathered; a vocabulary split over tp looked up where it lies
    (the other ranks' rows read as zeros) and summed over tp, so the table
    is never gathered whole (Megatron's vocabulary-parallel embedding)."""
    t = table.gather_dp().to(compute_dtype)
    d = table.tp_dim()
    if d is None:
        return torch.nn.functional.embedding(tokens, t)
    mesh, tp = table.ctx.mesh, table.ctx.tp
    if d != 0:
        t = coll.diff_all_gather(t, d, mesh, tp, "slice")
        return torch.nn.functional.embedding(tokens, t)
    v_loc = t.shape[0]
    rows = tokens - coll.axis_index(mesh, tp) * v_loc
    mine = (rows >= 0) & (rows < v_loc)
    e = torch.nn.functional.embedding(torch.where(mine, rows, 0), t)
    return coll.diff_all_reduce(e * mine[..., None].to(e.dtype), mesh, tp)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` its activations are not kept but
    recomputed in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``).  The recompute runs under the shard context of the
    forward: a CUDA backward runs on the autograd engine's own thread,
    which does not see the caller's context variables."""
    if remat:
        ctx = get_shard_ctx()
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              shard_ctx(ctx)))
    return fn(*args)
