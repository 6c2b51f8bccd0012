"""Mamba2 (SSD, state-space duality) blocks: the chunked prefill scan and
the one-token recurrent decode (port of ``repro/models/ssm.py``).

Within a chunk of Q tokens the output is a masked, decay-weighted
quadratic product; the state ``h (B, H, P, N)`` carries across chunks,
once per chunk (the reference's ``lax.scan`` over chunks is a Python loop
here).  Decode is the linear recurrence ``h <- h * exp(dt*A) + dt * (B ⊗
x)``, ``y = C · h + D * x``.

The in and out projections go through ``models.linear.dense`` and so run
on the residue matmul kernel under ``system="rns"``; the recurrence
multiplies by real decays ``exp(dt*A)`` in (0, 1) and stays in f32, as in
the reference.  No kernel of its own: the scan is eager PyTorch.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import linear
from repro_torch.models.layers import rmsnorm
from repro_torch.quant.quant import true_divide

__all__ = ["Mamba2Dims", "SsmCache", "init_ssm_cache", "init_mamba2",
           "mamba2_forward", "mamba2_decode", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 256


class Mamba2Dims(NamedTuple):
    d_model: int
    d_state: int
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def d_in_proj(self) -> int:
        # z, x, B, C, dt
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_heads)


class SsmCache(NamedTuple):
    conv: torch.Tensor   # (..., B, d_conv - 1, conv_dim) pre-conv history
    state: torch.Tensor  # (..., B, H, P, N) recurrent SSM state


def init_ssm_cache(batch: int, dims: Mamba2Dims, dtype=torch.float32,
                   device="cuda") -> SsmCache:
    return SsmCache(
        torch.zeros((batch, dims.d_conv - 1, dims.conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, dims.n_heads, dims.headdim, dims.d_state),
                    dtype=dtype, device=device))


def init_mamba2(gen: torch.Generator, dims: Mamba2Dims,
                device="cuda") -> dict[str, Any]:
    H = dims.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    ar = torch.arange(H, **f32)
    return {
        "in_proj": linear.init_dense(gen, dims.d_model, dims.d_in_proj,
                                     device),
        "conv_w": torch.randn(dims.d_conv, dims.conv_dim, generator=gen,
                              **f32) * 0.2,
        "conv_b": torch.zeros(dims.conv_dim, **f32),
        "dt_bias": torch.zeros(H, **f32),
        # A = -exp(A_log) in -[1, 2)
        "A_log": torch.log(1.0 + true_divide(ar, H)),
        "D": torch.ones(H, **f32),
        "norm": {"scale": torch.ones(dims.d_inner, **f32)},
        "out_proj": linear.init_dense(gen, dims.d_inner, dims.d_model,
                                      device),
    }


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _split_proj(zxbcdt: torch.Tensor, dims: Mamba2Dims):
    """Split the fused in_proj output into (z, xBC, dt)."""
    di, gs = dims.d_inner, dims.n_groups * dims.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * gs],
            zxbcdt[..., 2 * di + 2 * gs:])


def _split_xbc(xBC: torch.Tensor, dims: Mamba2Dims):
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    return xBC[..., :di], xBC[..., di: di + gn], xBC[..., di + gn:]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_buf: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps ``w (K, C)``, as K
    shifted adds in f32; ``init_buf`` (B, K-1, C) is the history (zeros
    when None)."""
    Kt = w.shape[0]
    if init_buf is None:
        init_buf = torch.zeros((xBC.shape[0], Kt - 1, xBC.shape[2]),
                               dtype=xBC.dtype, device=xBC.device)
    ext = torch.cat([init_buf.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for k in range(Kt):
        out = out + ext[:, k: k + S].to(torch.float32) * w[k].to(
            torch.float32)
    return F.silu(out + b.to(torch.float32)).to(xBC.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): out[i, j] = sum_{k=j+1..i} x[k] for i >= j,
    -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, x_dtype,
               dense_kw) -> torch.Tensor:
    """Mamba2's norm-then-gate and the out projection."""
    y = rmsnorm(params["norm"], y.to(x_dtype))
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    return linear.dense(params["out_proj"], y, **dense_kw)


# ---------------------------------------------------------------------------
# Chunked SSD forward (prefill)
# ---------------------------------------------------------------------------


def mamba2_forward(params: dict[str, Any], x: torch.Tensor,
                   dims: Mamba2Dims, *, chunk: int = DEFAULT_CHUNK,
                   dense_kw: dict[str, Any] | None = None,
                   init_cache: SsmCache | None = None,
                   return_cache: bool = False):
    """Full-sequence Mamba2 block.  x: (B, S, d_model) -> (B, S, d_model).

    S must be a multiple of ``min(chunk, S)`` when ``return_cache`` (the
    final state would absorb pad steps otherwise); without it a ragged S
    is padded and sliced.  With ``return_cache`` also returns the final
    :class:`SsmCache`.
    """
    dense_kw = dense_kw or {}
    B, S, _ = x.shape
    Q = min(chunk, S)
    if S % Q:
        if return_cache:
            raise ValueError(f"S={S} must be a multiple of chunk={Q} when "
                             "return_cache=True")
        xp = F.pad(x, (0, 0, 0, Q - S % Q))
        return mamba2_forward(params, xp, dims, chunk=Q,
                              dense_kw=dense_kw)[:, :S]
    nc = S // Q
    H, P, N, G = dims.n_heads, dims.headdim, dims.d_state, dims.n_groups

    zxbcdt = linear.dense(params["in_proj"], x, **dense_kw)
    z, xBC, dt = _split_proj(zxbcdt, dims)
    conv_hist = None if init_cache is None else init_cache.conv
    xBC_pre = xBC                                       # pre-conv, for cache
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"], conv_hist)
    xs, Bm, Cm = _split_xbc(xBC, dims)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])   # (B, S, H)
    A = -torch.exp(params["A_log"])                               # (H,)
    dA = dt * A

    xh = xs.reshape(B, S, H, P).to(torch.float32)
    Bh = Bm.reshape(B, S, G, N).to(torch.float32).repeat_interleave(
        H // G, dim=2)                                  # (B, S, H, N)
    Ch = Cm.reshape(B, S, G, N).to(torch.float32).repeat_interleave(
        H // G, dim=2)

    def chunk_of(t, c):
        return t[:, c * Q: (c + 1) * Q]

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init_cache is None else init_cache.state.to(torch.float32))
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, dAq = (chunk_of(t, c) for t in (xh, Bh, Ch, dt, dA))
        # within-chunk decay L[i, j] = exp(sum_{j<k<=i} dA_k)
        Lm = torch.exp(_segsum(dAq.transpose(1, 2)))    # (B, H, Q, Q)
        scores = torch.einsum("bihn,bjhn->bhij", Cq, Bq) * Lm
        scores = scores * dtq.transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhij,bjhp->bihp", scores, xq)
        decay_in = torch.exp(torch.cumsum(dAq, dim=1))  # (B, Q, H)
        y_off = torch.einsum("bihn,bhpn->bihp", Cq, h) * decay_in[..., None]
        total = torch.exp(dAq.sum(dim=1))               # (B, H)
        decay_to_end = torch.exp(dAq.sum(dim=1, keepdim=True)
                                 - torch.cumsum(dAq, dim=1))
        w = (dtq * decay_to_end)[..., None]             # (B, Q, H, 1)
        dh = torch.einsum("bjhn,bjhp->bhpn", Bq * w, xq)
        h = h * total[..., None, None] + dh
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1).reshape(B, S, H * P)
    y = y + (params["D"][None, None, :, None] * xh).reshape(B, S, H * P)
    out = _gated_out(params, y, z, x.dtype, dense_kw)
    if return_cache:
        Kt = dims.d_conv
        # the last K-1 pre-conv inputs, after the incoming history (so a
        # prompt shorter than K-1 stays exact); copied out so the prompt's
        # activations are not kept alive by a view
        hist0 = (torch.zeros((B, Kt - 1, dims.conv_dim), dtype=torch.float32,
                             device=x.device)
                 if init_cache is None else init_cache.conv)
        full = torch.cat([hist0.to(torch.float32),
                          xBC_pre.to(torch.float32)], dim=1)
        return out, SsmCache(full[:, -(Kt - 1):].clone(), h)
    return out


# ---------------------------------------------------------------------------
# Recurrent decode (one token)
# ---------------------------------------------------------------------------


def mamba2_decode(params: dict[str, Any], x: torch.Tensor, cache: SsmCache,
                  dims: Mamba2Dims, *,
                  dense_kw: dict[str, Any] | None = None
                  ) -> tuple[torch.Tensor, SsmCache]:
    """One decode step.  x: (B, 1, d_model) -> ``(out (B, 1, d_model),
    new cache)``; the conv history stays f32."""
    dense_kw = dense_kw or {}
    B = x.shape[0]
    H, P, N, G = dims.n_heads, dims.headdim, dims.d_state, dims.n_groups

    zxbcdt = linear.dense(params["in_proj"], x, **dense_kw)   # (B, 1, ·)
    z, xBC, dt = _split_proj(zxbcdt, dims)
    ext = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)   # (B, K, C)
    w = params["conv_w"].to(torch.float32)
    conv_out = (ext.to(torch.float32) * w[None]).sum(dim=1, keepdim=True)
    xBC = F.silu(conv_out + params["conv_b"].to(torch.float32))
    new_conv = ext[:, 1:].to(torch.float32)              # roll the buffer

    xs, Bm, Cm = _split_xbc(xBC, dims)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, 1, H)
    A = -torch.exp(params["A_log"])
    da = torch.exp(dt[:, 0] * A)                          # (B, H)

    xh = xs.reshape(B, H, P).to(torch.float32)
    Bh = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)  # (B, H, N)
    Ch = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)

    h = cache.state.to(torch.float32)
    h = (h * da[..., None, None]
         + (dt[:, 0, :, None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + params["D"][None, :, None] * xh
    out = _gated_out(params, y.reshape(B, 1, H * P), z, x.dtype, dense_kw)
    return out, SsmCache(new_conv, h)
