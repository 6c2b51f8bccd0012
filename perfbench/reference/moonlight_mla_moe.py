"""Plain PyTorch reference of Moonlight-16B-A3B (DeepSeek-V3's architecture:
multi-head latent attention and sigmoid-routed experts with shared
experts), in float32, and the stages of the served model's arithmetic.

The published model (``forward_f32``, float32 throughout, dropless):

* RMSNorm (eps 1e-5) before attention and before the feed-forward half;
* MLA with no query LoRA: ``q = wq(h)`` per head ``nope + rope`` wide;
  ``kv_a(h)`` gives the latent ``c`` (RMS-normed by ``kv_norm``) and one
  rotary key ``k_pe`` for all heads; ``kv_b(c)`` gives each head's
  ``k_nope`` and value; rotary positions (theta 5e4, no scaling) on the
  rope parts only, in DeepSeek-V3's pairing: dims ``2i, 2i+1`` are a pair,
  de-interleaved and rotated as halves; softmax scale ``(nope + rope) **
  -0.5``; ``wo`` back to the model width;
* layer 0 a dense SwiGLU; the others 64 routed SwiGLU experts, 6 a token:
  sigmoid scores of the router's logits, the 6 largest ``score + bias``
  chosen (the bias, ``e_score_correction_bias``, weights nothing), the
  chosen scores over their sum (+ 1e-20) times ``routed_scale`` as gates;
  plus the shared experts, one SwiGLU of ``n_shared x`` the expert width,
  on every token;
* a final RMSNorm and an untied ``lm_head``.

The served arithmetic (:class:`Served`, at a :class:`Prec`): every weight
matrix int4 per output channel, every activation row int4 per token, the
integer products exact, scaled back and rounded to the compute dtype
(bf16) where the program rounds; the router and its bias in float (its
logits summed in float64 and rounded to f32); the expert products' f32
outputs unrounded until ``silu(g) u``; the cache a token leaves, the
normed latent and the roped ``k_pe``, in rns8 pages (a per-token scale
each, rns8's centred range 119); decode reads the pages back and expands
them with ``kv_b``.  The control is one precision step below (int3 codes,
fp8 e4m3 roundings, rns4 pages).

A departure of the served system, written here as a rule of its own
(:func:`capacity`, :func:`place`): each expert takes at most ``C =
ceil(n K / E x cf)`` rounded up to 8 (token, slot) pairs of a call, ``n``
the real tokens of the call, in the order (prompt, position, slot);
pairs past it are dropped (the published model is dropless).  Padded
rows of a batch take no place.

Integer products run as float32 products (exact: every sum stays below
2**24) or on ``torch._int_mm`` on the card.  Nothing here imports the
program.
"""
from __future__ import annotations

import dataclasses
import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-5


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
    """``x`` rounded to the precision's compute dtype, held as bf16 (as
    f32 where the compute dtype is f32)."""
    if prec.dtype == torch.float32:
        return x.to(torch.float32)
    return x.to(prec.dtype).to(torch.bfloat16)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full_like(x, d)


def quantize(x: torch.Tensor, qmax: int, dim: int):
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
    return qa @ codes


def qprod(x: torch.Tensor, w: QWeight, prec: Prec) -> torch.Tensor:
    """The served product of rows ``x (..., K)``, f32 and unrounded."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    qx, sx = quantize(x2, prec.qmax, dim=-1)
    return (int_matmul(qx, w.codes) * sx * w.scale).reshape(*lead, -1)


def dense(x: torch.Tensor, w: QWeight, prec: Prec) -> torch.Tensor:
    return rnd(qprod(x, w, prec), prec)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, prec: Prec) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + EPS).to(x.dtype)
    return rnd(x * inv * scale.to(x.dtype), prec)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float, prec: Prec
         ) -> torch.Tensor:
    """DeepSeek-V3's rotary positions on ``x (L, H, d)`` at ``pos (L,)``:
    pairs ``(2i, 2i+1)``, de-interleaved (evens, then odds) and rotated as
    halves at frequency ``theta ** (-2i / d)``; the output keeps the
    de-interleaved order, as the published ``apply_rotary_pos_emb``."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
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
    """Causal softmax attention in f32: q (R, H, dk) at ``q_pos``, k (T, H,
    dk) and v (T, H, dv) at 0..T-1 -> (R, H * dv) f32, scale ``dk **
    -0.5``.  The unnormalized probabilities are rounded to ``p_dtype``
    before the product with v."""
    R, H, dk = q.shape
    T, dv = k.shape[0], v.shape[-1]
    s = torch.einsum("rhd,thd->hrt", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / dk ** 0.5)
    mask = torch.arange(T, device=q.device)[None, :] <= q_pos[:, None]
    m = torch.where(mask, s, float("-inf")).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    o = torch.einsum("hrt,thd->hrd", p.to(p_dtype).to(torch.float32),
                     v.to(torch.float32)) / p.sum(dim=-1, keepdim=True)
    return o.permute(1, 0, 2).reshape(R, H * dv)


def kv_quant(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """A latent or key row ``(T, 1, d)`` as a page holds it: per token codes
    over d times their scale, f32."""
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
    """f32 values of a prompt's latent pages, ``planes (n_pages, ps, lanes,
    1, d)`` as the pool keeps them (the latent ``c`` in its K pages, the
    roped ``k_pe`` in its V pages) and their scales, as ``(n_pages * ps, 1,
    d)`` rows."""
    if kv_format != "rns8":
        raise ValueError(f"no decoding of {kv_format!r} pages here")
    v = rns8_values(planes[:, :, 0]).to(torch.float32) * scale
    return v.reshape(-1, *v.shape[2:])


def capacity(n_tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    """Slots an expert takes in one call of ``n_tokens`` real tokens."""
    c = math.ceil(n_tokens * top_k / n_experts * cf)
    return max(8, (c + 7) // 8 * 8)


def place(expert_idx: torch.Tensor, n_experts: int, cap: int
          ) -> torch.Tensor:
    """Which (token, slot) pairs of ``expert_idx (n, k)`` (real tokens in
    call order) an expert of capacity ``cap`` keeps: ``(n, k)`` bool, in
    the order (token, slot)."""
    flat = expert_idx.reshape(-1)
    onehot = (flat[:, None] == torch.arange(n_experts,
                                            device=flat.device)).long()
    before = torch.cumsum(onehot, dim=0) - onehot
    return (before.gather(1, flat[:, None])[:, 0] < cap).reshape(
        expert_idx.shape)


def route(router_w: torch.Tensor, bias: torch.Tensor, h: torch.Tensor,
          top_k: int, routed_scale: float):
    """Normed rows ``h (n, d)`` -> (expert ids (n, k), gates (n, k) f32):
    logits summed in float64 and rounded to f32, sigmoid scores, the k
    largest ``score + bias`` (ties to the lower index)."""
    logits = (h.to(torch.float64) @ router_w.to(torch.float64)).to(
        torch.float32)
    scores = torch.sigmoid(logits)
    idx = torch.sort(scores + bias.to(torch.float32), dim=-1,
                     descending=True, stable=True).indices[:, :top_k]
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * routed_scale


@dataclasses.dataclass(frozen=True)
class Dims:
    """The architecture's sizes, from the configuration's published keys."""

    d: int
    heads: int
    nope: int
    rope: int
    dv: int
    rank: int
    experts: int
    top_k: int
    routed_scale: float
    theta: float
    first_dense: int
    cf: float

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        return cls(cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                   cfg["v_head_dim"], cfg["kv_lora_rank"],
                   cfg["n_routed_experts"], cfg["num_experts_per_tok"],
                   float(cfg["routed_scaling_factor"]),
                   float(cfg["rope_theta"]), cfg["first_k_dense_replace"],
                   float(cfg["port"]["capacity_factor"]))


_MATS = ("wq", "kv_a", "kv_b", "wo", "w_gate", "w_up", "w_down", "s_gate",
         "s_up", "s_down")


class Served:
    """One decoder layer's weights at a precision and its stages.  ``w``
    holds f32 leaves by name (the family's ``layer_leaves``): ``wq``,
    ``kv_a``, ``kv_b``, ``wo``, the norms; a dense layer's ``w_gate``,
    ``w_up``, ``w_down``; an expert layer's ``router``, ``bias``, expert
    stacks ``e_gate``, ``e_up`` (E, d, f), ``e_down`` (E, f, d) and shared
    ``s_gate``, ``s_up``, ``s_down``."""

    def __init__(self, w: dict[str, torch.Tensor], cfg: dict, prec: Prec):
        self.prec, self.dims = prec, Dims.of(cfg)
        self.norms = {k: w[k] for k in ("attn_norm", "kv_norm", "mlp_norm")}
        self.mats = {k: qweight(w[k], prec.qmax) for k in _MATS if k in w}
        self.moe = "router" in w
        if self.moe:
            self.router, self.bias = w["router"], w["bias"]
            self.experts = [
                {k: qweight(w["e_" + k][e], prec.qmax)
                 for k in ("gate", "up", "down")}
                for e in range(w["e_gate"].shape[0])]

    # -- attention ---------------------------------------------------------

    def q(self, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        D, p = self.dims, self.prec
        q = dense(h, self.mats["wq"], p).reshape(h.shape[0], D.heads,
                                                  D.nope + D.rope)
        return torch.cat([q[..., :D.nope],
                          rope(q[..., D.nope:], pos, D.theta, p)], dim=-1)

    def latent(self, h: torch.Tensor, pos: torch.Tensor):
        """The cache rows a token leaves: ``c (L, 1, rank)``, ``k_pe (L, 1,
        rope)``, in the compute dtype."""
        D, p = self.dims, self.prec
        ckv = dense(h, self.mats["kv_a"], p)
        c = rmsnorm(ckv[:, :D.rank], self.norms["kv_norm"], p)
        k_pe = rope(ckv[:, None, D.rank:], pos, D.theta, p)
        return c[:, None], k_pe

    def expand(self, c: torch.Tensor, k_pe: torch.Tensor):
        """Every head's k and v from latent rows ``(T, 1, ·)``."""
        D, p = self.dims, self.prec
        T = c.shape[0]
        kv = dense(c[:, 0], self.mats["kv_b"], p).reshape(
            T, D.heads, D.nope + D.dv)
        k = torch.cat([kv[..., :D.nope],
                       k_pe.expand(T, D.heads, D.rope)], dim=-1)
        return k, kv[..., D.nope:]

    def attend_rows(self, h_rows, pos_rows, k, v) -> torch.Tensor:
        """Queries of normed rows ``h_rows`` at ``pos_rows`` over ``k, v``,
        through ``wo``."""
        p = self.prec
        o = attend(self.q(h_rows, pos_rows), k, v, pos_rows, p.dtype)
        return dense(rnd(o, p), self.mats["wo"], p)

    def attn_prefill(self, h: torch.Tensor, rows: torch.Tensor):
        """The attention block over a prompt's normed rows ``h (L, d)``: its
        output at ``rows`` and the prompt's ``c`` and ``k_pe``."""
        pos = torch.arange(h.shape[0], device=h.device)
        c, k_pe = self.latent(h, pos)
        k, v = self.expand(c, k_pe)
        return self.attend_rows(h[rows], pos[rows], k, v), c, k_pe

    # -- feed-forward ------------------------------------------------------

    def _swiglu(self, h: torch.Tensor, names: tuple[str, str, str]):
        m, p = self.mats, self.prec
        g = dense(h, m[names[0]], p)
        u = dense(h, m[names[1]], p)
        a = rnd(torch.nn.functional.silu(g.to(torch.float32)).to(u.dtype)
                * u, p)
        return dense(a, m[names[2]], p)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """A dense layer's feed-forward block of residual rows ``x``."""
        h = rmsnorm(x, self.norms["mlp_norm"], self.prec)
        return self._swiglu(h, ("w_gate", "w_up", "w_down"))

    def route(self, x: torch.Tensor):
        """Expert ids and gates of residual rows ``x (n, d)``."""
        D = self.dims
        h = rmsnorm(x, self.norms["mlp_norm"], self.prec)
        return route(self.router, self.bias, h, D.top_k, D.routed_scale)

    def expert(self, e: int, h: torch.Tensor) -> torch.Tensor:
        """Routed expert ``e`` on normed rows ``h``, in the compute dtype."""
        w, p = self.experts[e], self.prec
        g, u = qprod(h, w["gate"], p), qprod(h, w["up"], p)
        a = rnd(torch.nn.functional.silu(g) * u, p)
        return dense(a, w["down"], p)

    def moe_rows(self, x: torch.Tensor, idx: torch.Tensor,
                 gates: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """The expert block's output at residual rows ``x (R, d)`` routed
        to ``idx``, ``gates``, ``keep`` (R, k): the kept experts' outputs
        times their gates, summed, plus the shared experts."""
        p = self.prec
        h = rmsnorm(x, self.norms["mlp_norm"], p)
        outs = torch.zeros((*idx.shape, h.shape[-1]), dtype=h.dtype,
                           device=h.device)
        for r in range(idx.shape[0]):
            for j in range(idx.shape[1]):
                if keep[r, j]:
                    outs[r, j] = self.expert(int(idx[r, j]), h[r:r + 1])[0]
        y = (outs * gates[..., None].to(h.dtype)).sum(dim=1)
        y = rnd(y, p)
        return rnd(y + self._swiglu(h, ("s_gate", "s_up", "s_down")), p)


def head(w: torch.Tensor, final_norm: torch.Tensor, x: torch.Tensor,
         prec: Prec) -> torch.Tensor:
    """Logits (R, vocab) f32 of residual rows ``x``: the untied
    ``lm_head`` ``w (d, vocab)``."""
    return dense(rmsnorm(x, final_norm, prec), qweight(w, prec.qmax),
                 prec).to(torch.float32)


# ---------------------------------------------------------------------------
# The served model end to end (the CPU tests): prefill, then decode steps
# that read the latent rows back as the pages hold them
# ---------------------------------------------------------------------------


class ServedModel:
    """The served model over a batch of prompts: ``layers`` of
    :class:`Served`, the embedding table, the final norm and the head."""

    def __init__(self, layers: list[Served], table, final_norm, lm_head,
                 prec: Prec):
        self.layers, self.table = layers, table
        self.final_norm, self.lm_head, self.prec = final_norm, lm_head, prec
        self.cache: list[list[tuple[torch.Tensor, torch.Tensor]]] = []

    def _x(self, tokens):
        return rnd(self.table[tokens], self.prec)

    def _moe(self, L: Served, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The expert block over the call's real rows, in call order."""
        D = L.dims
        flat = torch.cat(xs)
        idx, gates = L.route(flat)
        keep = place(idx, D.experts, capacity(flat.shape[0], D.experts,
                                              D.top_k, D.cf))
        y = L.moe_rows(flat, idx, gates, keep)
        return list(torch.split(y, [x.shape[0] for x in xs]))

    def _ff(self, L: Served, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        if L.moe:
            ys = self._moe(L, xs)
        else:
            ys = [L.mlp(x) for x in xs]
        return [rnd(x + y, self.prec) for x, y in zip(xs, ys)]

    def prefill(self, prompts: list[torch.Tensor]) -> torch.Tensor:
        """Logits (B, vocab) at each prompt's last token; keeps the latent
        cache of every prompt."""
        p = self.prec
        xs = [self._x(t) for t in prompts]
        self.cache = [[] for _ in prompts]
        for L in self.layers:
            hs = []
            for b, x in enumerate(xs):
                h = rmsnorm(x, L.norms["attn_norm"], p)
                rows = torch.arange(x.shape[0], device=x.device)
                a, c, k_pe = L.attn_prefill(h, rows)
                self.cache[b].append((c, k_pe))
                hs.append(rnd(x + a, p))
            xs = self._ff(L, hs)
        last = torch.cat([x[-1:] for x in xs])
        return head(self.lm_head, self.final_norm, last, p)

    def decode(self, tokens: torch.Tensor, paged: bool = True
               ) -> torch.Tensor:
        """One step, token ``tokens[b]`` appended to prompt ``b``; attention
        reads every row's latent as its rns8 page holds it (as it is, with
        ``paged`` False: pages of the compute dtype)."""
        p = self.prec
        xs = [self._x(tokens[b:b + 1]) for b in range(tokens.shape[0])]
        for li, L in enumerate(self.layers):
            hs = []
            for b, x in enumerate(xs):
                c_all, kpe_all = self.cache[b][li]
                pos = torch.tensor([c_all.shape[0]], device=x.device)
                h = rmsnorm(x, L.norms["attn_norm"], p)
                c, k_pe = L.latent(h, pos)
                c_all, kpe_all = torch.cat([c_all, c]), torch.cat(
                    [kpe_all, k_pe])
                self.cache[b][li] = (c_all, kpe_all)
                if paged:
                    c_all = rnd(kv_quant(c_all, p.kv_qmax), p)
                    kpe_all = rnd(kv_quant(kpe_all, p.kv_qmax), p)
                k, v = L.expand(c_all, kpe_all)
                hs.append(rnd(x + L.attend_rows(h, pos, k, v), p))
            xs = self._ff(L, hs)
        return head(self.lm_head, self.final_norm, torch.cat(xs), p)


# ---------------------------------------------------------------------------
# The published model in float32 (dropless, no quantization)
# ---------------------------------------------------------------------------


def _rms32(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def _swiglu32(x, g, u, d):
    return (torch.nn.functional.silu(x @ g) * (x @ u)) @ d


def forward_f32(leaves: list[dict[str, torch.Tensor]], cfg: dict,
                table: torch.Tensor, final_norm: torch.Tensor,
                lm_head: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (L, vocab) of one prompt ``tokens (L,)`` through the published
    model in float32 (``leaves``: each layer's, as :class:`Served` reads
    them)."""
    D = Dims.of(cfg)
    f32 = Prec(bits=4, dtype=torch.float32)
    x = table[tokens].to(torch.float32)
    L = x.shape[0]
    pos = torch.arange(L, device=x.device)
    for w in leaves:
        h = _rms32(x, w["attn_norm"])
        q = (h @ w["wq"]).reshape(L, D.heads, D.nope + D.rope)
        q = torch.cat([q[..., :D.nope], rope(q[..., D.nope:], pos, D.theta,
                                             f32)], dim=-1)
        ckv = h @ w["kv_a"]
        c = _rms32(ckv[:, :D.rank], w["kv_norm"])
        k_pe = rope(ckv[:, None, D.rank:], pos, D.theta, f32)
        kv = (c @ w["kv_b"]).reshape(L, D.heads, D.nope + D.dv)
        k = torch.cat([kv[..., :D.nope], k_pe.expand(L, D.heads, D.rope)], -1)
        o = attend(q, k, kv[..., D.nope:], pos, torch.float32)
        x = x + o @ w["wo"]
        h = _rms32(x, w["mlp_norm"])
        if "router" not in w:
            x = x + _swiglu32(h, w["w_gate"], w["w_up"], w["w_down"])
            continue
        idx, gates = route(w["router"], w["bias"], h, D.top_k,
                           D.routed_scale)
        y = _swiglu32(h, w["s_gate"], w["s_up"], w["s_down"])
        for j in range(D.top_k):
            for e in idx[:, j].unique().tolist():
                r = idx[:, j] == e
                y[r] += gates[r, j, None] * _swiglu32(
                    h[r], w["e_gate"][e], w["e_up"][e], w["e_down"][e])
        x = x + y
    return _rms32(x, final_norm) @ lm_head
