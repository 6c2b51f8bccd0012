"""Plain PyTorch reference of a dense GQA decoder with qk-norm (Qwen3) under
the residue number system's arithmetic, stage by stage.

The published architecture: RMSNorm, rotary positions, grouped-query
attention with q and k RMS-normed per head, a SwiGLU MLP, tied embeddings.
The served model's arithmetic, worked out here from the float weights the
benchmark made:

* each weight matrix is quantized symmetrically per output channel (over
  its input axis) to ``bits``-bit codes, each activation row per token;
  the integer product is exact (computing it is the residue planes', the
  CRT decode's and the kernels' whole job), then scaled back by both
  scales and rounded to the compute dtype;
* prefill attention reads the compute-dtype K and V, and writes them into
  8-bit pages, each (token, head) row quantized symmetrically over the
  head dimension (rns8's centered range: 119), whose bytes hold the
  value's residues mod 15 (low four bits) and mod 16 (high four bits);
* the logits are the tied table's product.

The stages are functions of their inputs, so the check can run each from
the program's own input to it (``perfbench/harness/drivers/serve.py``).
:class:`Prec` carries the precision: the configuration's (int4 codes,
bf16 roundings, rns8 pages), or the control's one step below (int3
codes, fp8 e4m3 roundings, rns4 pages).

Integer products run on ``torch._int_mm`` on the card (int8 codes, exact
int32 sums) and as float32 products elsewhere (exact: every sum stays
below 2**24).  Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import torch

EPS = 1e-5          # the port's RMSNorm epsilon (the configuration's)


@dataclasses.dataclass(frozen=True)
class Prec:
    bits: int = 4                        # weight and activation codes
    dtype: torch.dtype = torch.bfloat16  # every compute-dtype rounding
    kv_qmax: int = 119                   # rns8 (15, 16); rns4 (3, 4): 5

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


CONFIGURED = Prec()
CONTROL = Prec(bits=3, dtype=torch.float8_e4m3fn, kv_qmax=5)


def rnd(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """``x`` rounded to the precision's compute dtype, held as bf16."""
    return x.to(prec.dtype).to(torch.bfloat16)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full_like(x, d)


def quantize(x: torch.Tensor, qmax: int, dim: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric codes of f32 ``x`` along ``dim`` (round half to even) and
    their f32 scales (kept dims)."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), qmax)
    return torch.round(x / scale).clamp_(-qmax, qmax), scale


@dataclasses.dataclass
class QWeight:
    codes: torch.Tensor      # (K, N): int8 (K-contiguous) on the card, f32
    scale: torch.Tensor      # (1, N) f32


def qweight(w: torch.Tensor, qmax: int) -> QWeight:
    q, s = quantize(w.to(torch.float32), qmax, dim=0)
    K, N = q.shape
    if q.is_cuda and K % 8 == 0 and N % 8 == 0:
        q = q.to(torch.int8).t().contiguous().t()
    return QWeight(q, s)


def int_matmul(qa: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued f32 (M, K) codes and weight codes,
    as f32."""
    if codes.dtype == torch.int8:
        M, K = qa.shape
        a = qa.to(torch.int8)
        if M <= 16:
            a = torch.cat([a, a.new_zeros(17 - M, K)])
        return torch._int_mm(a, codes)[:M].to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return qa @ codes
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def dense(x: torch.Tensor, w: QWeight, prec: Prec) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    qx, sx = quantize(x2, prec.qmax, dim=-1)
    y = int_matmul(qx, w.codes) * sx * w.scale
    return rnd(y.reshape(*lead, -1), prec)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, prec: Prec) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + EPS).to(x.dtype)
    return rnd(x * inv * scale.to(x.dtype), prec)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float, prec: Prec
         ) -> torch.Tensor:
    """x (L, H, hd) at positions ``pos`` (L,)."""
    half = x.shape[-1] // 2
    freqs = theta ** _div(-torch.arange(0, half, dtype=torch.float32,
                                        device=x.device), half)
    ang = pos.to(torch.float32)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return rnd(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1),
               prec)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, p_dtype: torch.dtype) -> torch.Tensor:
    """Causal softmax attention in f32: q (R, H, hd) at ``q_pos``, k and v
    (T, Kv, hd) at 0..T-1 -> (R, H * hd) f32.  The unnormalized
    probabilities are rounded to ``p_dtype`` before the product with v
    (the compute dtype in the prefill, as its tensor cores take them)."""
    R, H, hd = q.shape
    T, Kv = k.shape[0], k.shape[1]
    qg = q.to(torch.float32).reshape(R, Kv, H // Kv, hd)
    s = torch.einsum("rkgd,tkd->kgrt", qg, k.to(torch.float32))
    s = s * (1.0 / hd ** 0.5)
    mask = torch.arange(T, device=q.device)[None, :] <= q_pos[:, None]
    m = torch.where(mask, s, float("-inf")).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    o = torch.einsum("kgrt,tkd->kgrd", p.to(p_dtype).to(torch.float32),
                     v.to(torch.float32)) / p.sum(dim=-1, keepdim=True)
    return o.permute(2, 0, 1, 3).reshape(R, H * hd)


def kv_quant(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """K or V (T, Kv, hd) as a page holds it: per (token, head) codes over
    hd times their scale, f32."""
    q, s = quantize(x.to(torch.float32), qmax, dim=-1)
    return q * s


def rns8_values(planes: torch.Tensor) -> torch.Tensor:
    """int32 values of rns8 page bytes (uint8, any shape): the value in
    [-119, 120] whose residues mod 15 and mod 16 the low and high nibbles
    hold, each in two's complement."""
    table = torch.zeros(15 * 16, dtype=torch.int32, device=planes.device)
    for v in range(-119, 121):
        table[(v % 15) * 16 + v % 16] = v
    b = planes.to(torch.int32)
    f0, f1 = b & 15, (b >> 4) & 15
    r0 = torch.where(f0 >= 8, f0 - 16, f0) % 15
    r1 = torch.where(f1 >= 8, f1 - 16, f1) % 16
    return table[r0 * 16 + r1]


def page_values(planes: torch.Tensor, scale: torch.Tensor, kv_format: str
                ) -> torch.Tensor:
    """f32 values of a prompt's pages, ``planes (n_pages, ps, lanes, Kv,
    hd)`` as the pool keeps them and their scales, as ``(n_pages * ps,
    Kv, hd)`` rows.  Only the configuration's format is read here."""
    if kv_format != "rns8":
        raise ValueError(f"no decoding of {kv_format!r} pages here")
    v = rns8_values(planes[:, :, 0]).to(torch.float32) * scale
    return v.reshape(-1, *v.shape[2:])


class Layer:
    """One decoder layer's quantized weights and its stages."""

    def __init__(self, w: dict[str, torch.Tensor], cfg: dict, prec: Prec):
        self.prec, self.cfg = prec, cfg
        self.norms = {k: w[k] for k in ("attn_norm", "q_norm", "k_norm",
                                        "mlp_norm")}
        self.mats = {k: qweight(w[k], prec.qmax)
                     for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                               "w_down")}

    def qkv(self, h: torch.Tensor, pos: torch.Tensor):
        """q, k, v of normed rows ``h`` (L, d) at positions ``pos``."""
        c, m, p = self.cfg, self.mats, self.prec
        H, Kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        L = h.shape[0]
        q = dense(h, m["wq"], p).reshape(L, H, hd)
        k = dense(h, m["wk"], p).reshape(L, Kv, hd)
        v = dense(h, m["wv"], p).reshape(L, Kv, hd)
        theta = c["rope_theta"]
        q = rope(rmsnorm(q, self.norms["q_norm"], p), pos, theta, p)
        k = rope(rmsnorm(k, self.norms["k_norm"], p), pos, theta, p)
        return q, k, v

    def attn_prefill(self, h: torch.Tensor, rows: torch.Tensor):
        """The attention block over a prompt's normed rows ``h`` (L, d):
        its output at ``rows`` and the prompt's k and v."""
        pos = torch.arange(h.shape[0], device=h.device)
        q, k, v = self.qkv(h, pos)
        o = attend(q[rows], k, v, pos[rows], self.prec.dtype)
        return dense(rnd(o, self.prec), self.mats["wo"], self.prec), k, v

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP block of residual rows ``x`` (R, d), its norm included."""
        m, p = self.mats, self.prec
        h = rmsnorm(x, self.norms["mlp_norm"], p)
        g = dense(h, m["w_gate"], p)
        u = dense(h, m["w_up"], p)
        a = rnd(torch.nn.functional.silu(g.to(torch.float32)).to(u.dtype)
                * u, p)
        return dense(a, m["w_down"], p)


def head(table: torch.Tensor, final_norm: torch.Tensor, x: torch.Tensor,
         prec: Prec) -> torch.Tensor:
    """Logits (R, vocab) f32 of residual rows ``x`` (R, d)."""
    w = qweight(table.T, prec.qmax)
    return dense(rmsnorm(x, final_norm, prec), w, prec).to(torch.float32)
