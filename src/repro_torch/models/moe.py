"""Top-k mixture of experts with capacity-based dispatch (port of
``repro/models/moe.py``).

1. router logits (a plain matmul, rounded to f32: routing is not
   quantized arithmetic) -> softmax -> top-k expert ids and renormalised
   gates;
2. each (token, slot) gets its position inside its expert from an
   exclusive cumsum over the flattened ``(T·k, E)`` one-hot; positions at
   or past the capacity ``C = moe_capacity(T, E, k, cf)`` are dropped;
3. the kept slots are scattered into ``(E, C, d)`` buffers, the stacked
   expert SwiGLU runs as three einsums, and the outputs are gathered back
   and summed over the k slots, weighted by their gates.

Under ``system="rns"`` the three einsums run on the resident expert stacks
through ``linear.stacked_qmatmul`` (one residue matmul launch for the whole
stack, where the reference scans its kernel over the experts).

Where the reference's semantics are kept on purpose:

* ``lax.top_k`` breaks ties toward the lower expert index, which
  ``torch.topk`` does not promise: a stable descending sort, first k;
* the reference adds dropped slots into the buffer as zeros at (0, 0);
  only kept slots are written here (dropped ones go to a spare row that is
  cut off), which gives the same buffer with no atomics;
* dtypes: ``h = silu(g) u`` in ``x.dtype``, the down einsum's output in
  ``x.dtype``, the gates cast to ``x.dtype`` before the k-sum;
* the router's matmul sums in float64 and rounds once to f32, so no TF32
  setting and no summation order moves its logits (one flipped ulp can
  change the top-k), on the card as on the CPU.

DeepSeek-V3's routing (a router with a correction ``bias`` beside its
weight, :func:`route_sigmoid`; the port's
:class:`~repro_torch.configs.base.MlaMoeConfig`): sigmoid scores of
the same f32 logits, the top k of score plus a per-expert correction bias
(the bias picks the experts and weights nothing), the chosen scores
normalised and scaled by ``routed_scale``.  Shared experts
(``params["shared"]``, one SwiGLU) see every row and are added to the
routed output.  Given ``valid`` (the prompt rows of a right-padded
prefill) and ``n_tokens`` (their count, which the caller has on the host),
padded rows take no expert slot and the capacity follows the real rows,
so one prompt's padding never displaces the next prompt's tokens.

The switch-transformer load-balance loss ``E sum_e f_e p_e``, a training
term, comes with the output under ``moe(..., with_aux=True)`` (the training
forward) and alone from :func:`load_balance_loss`.  Under ``rns`` /
``sdrns`` a float expert stack (training) goes through the per-call path of
``linear.stacked_qmatmul``, with its straight-through backward.

In the sharded train step (``ShardCtx.rows_local``) each dp rank routes its
own rows as the reference's GSPMD step routes the global batch: the
capacity follows the global token count, each rank's positions inside an
expert are offset by the lower dp ranks' counts (the global batch's token
order: dp block 0's rows first), and both means of the aux loss are taken
over the global batch.  Each rank keeps its own slots of the ``(E, C, d)``
buffers (the others' rows are zeros, which the experts map to zeros).
Expert stacks split on E over tp (EP, where E divides the tensor axes) run
each rank's experts on its block of the buffers and all-gather the
outputs; stacks split inside each expert run ``linear``'s column and row
plans.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models import linear
from repro_torch.models import mlp as mlp_mod
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import ShardedParam

__all__ = ["init_moe", "init_moe_mla", "load_balance_loss", "moe",
           "moe_capacity", "route", "route_sigmoid", "place"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             device="cuda") -> dict[str, Any]:
    scale_in = (2.0 / (d_model + d_ff)) ** 0.5

    def stack(*shape):
        return torch.randn(*shape, generator=gen, device=device) * scale_in

    return {
        "router": {"w": torch.randn(d_model, n_experts, generator=gen,
                                    device=device) * 0.02},
        "w_gate": stack(n_experts, d_model, d_ff),
        "w_up": stack(n_experts, d_model, d_ff),
        "w_down": stack(n_experts, d_ff, d_model),
    }


def init_moe_mla(gen: torch.Generator, d_model: int, d_ff: int,
                 n_experts: int, n_shared: int, device="cuda"
                 ) -> dict[str, Any]:
    """:func:`init_moe`'s experts, a zero correction bias beside the router
    weight, and the shared SwiGLU of ``n_shared * d_ff``."""
    p = init_moe(gen, d_model, d_ff, n_experts, device)
    p["router"]["bias"] = torch.zeros(n_experts, device=device)
    p["shared"] = mlp_mod.init_swiglu(gen, d_model, n_shared * d_ff, device)
    return p


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25, *, multiple: int = 8) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    c = math.ceil(n_tokens * top_k / n_experts * capacity_factor)
    return max(multiple, (c + multiple - 1) // multiple * multiple)


def route(router_w: torch.Tensor, xt: torch.Tensor, top_k: int):
    """(T, d) tokens -> ``(probs (T, E), gates (T, k), expert_idx (T, k))``.

    f32 logits (summed in float64), softmax, the k largest probabilities
    (ties to the lower index), gates renormalised to sum to one.
    """
    logits = torch.matmul(xt.to(torch.float64),
                          router_w.to(torch.float64)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :top_k]
    expert_idx = top.indices[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, expert_idx


def route_sigmoid(router_w: torch.Tensor, bias: torch.Tensor,
                  xt: torch.Tensor, top_k: int, routed_scale: float):
    """(T, d) tokens -> ``(scores (T, E), gates (T, k), expert_idx (T, k))``
    under DeepSeek-V3's ``noaux_tc`` routing with one group.

    f32 logits (summed in float64, as :func:`route`), sigmoid scores; the
    experts are the k largest ``score + bias`` (a stable descending sort:
    ties to the lower index); the gates are the chosen experts' scores
    over their sum (+ 1e-20) times ``routed_scale``.
    """
    logits = torch.matmul(xt.to(torch.float64),
                          router_w.to(torch.float64)).to(torch.float32)
    scores = torch.sigmoid(logits)
    choice = scores + bias.to(torch.float32)
    expert_idx = torch.sort(choice, dim=-1, descending=True,
                            stable=True).indices[:, :top_k]
    w = scores.gather(1, expert_idx)
    gates = w / (w.sum(-1, keepdim=True) + 1e-20) * routed_scale
    return scores, gates, expert_idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as a comparison (int64): the same on every
    device, where ``F.one_hot`` reads its indices back to the host on the
    CPU to check them (a step's work count must not depend on the
    device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def place(expert_idx: torch.Tensor, n_experts: int, capacity: int,
          rows=None, valid: torch.Tensor | None = None):
    """Each (token, slot)'s expert and position inside it, flattened to
    ``(T·k,)``, and which of them fit the capacity; with ``rows``
    (``sharding.dp_rows()``) the positions follow the lower dp ranks' slots.
    With ``valid (T,)`` the slots of invalid rows (padding) take no
    position and are not kept."""
    flat_e = expert_idx.reshape(-1)
    onehot = _one_hot(flat_e, n_experts).to(torch.int32)
    if valid is not None:
        vs = valid[:, None].expand(expert_idx.shape).reshape(-1)
        onehot = onehot * vs[:, None].to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
    if rows is not None:
        mesh, dp, _ = rows
        counts = coll.all_gather(onehot.sum(0, dtype=torch.int32)[None], 0,
                                 mesh, dp)
        below = counts[:coll.axis_index(mesh, dp)].sum(0, dtype=torch.int32)
        pos_in_e = pos_in_e + below[flat_e]
    keep = pos_in_e < capacity
    if valid is not None:
        keep = keep & vs
    return flat_e, pos_in_e, keep


def _switch_aux(probs: torch.Tensor, expert_idx: torch.Tensor,
                n_experts: int, rows=None) -> torch.Tensor:
    tok = _one_hot(expert_idx, n_experts).to(torch.float32).sum(1)
    if rows is None:
        frac_prob, frac_tok = probs.mean(dim=0), tok.mean(0)
    else:               # the global batch's means, the same on every rank
        mesh, dp, n = rows
        T = probs.shape[0] * n
        frac_prob = coll.diff_all_reduce(probs.sum(0), mesh, dp) / T
        frac_tok = coll.all_reduce(tok.sum(0), mesh, dp) / T
    return n_experts * (frac_prob * frac_tok).sum()


def load_balance_loss(router_w: torch.Tensor, x: torch.Tensor, *,
                      n_experts: int, top_k: int) -> torch.Tensor:
    """The switch-transformer aux loss of ``moe``'s routing of x (B, S, d):
    ``E sum_e f_e p_e``, an f32 scalar."""
    probs, _, expert_idx = route(router_w, x.reshape(-1, x.shape[-1]),
                                 top_k)
    return _switch_aux(probs, expert_idx, n_experts)


def moe(params: dict[str, Any], x: torch.Tensor, *, n_experts: int,
        top_k: int, capacity_factor: float = 1.25,
        dense_kw: dict[str, Any] | None = None, with_aux: bool = False,
        routed_scale: float = 1.0, valid: torch.Tensor | None = None,
        n_tokens: int | None = None):
    """x: (B, S, d) -> y (B, S, d); with ``with_aux`` ``(y, aux)``, the
    load-balance loss of this routing.

    ``dense_kw`` picks the arithmetic of the expert einsums as it does for
    ``linear.dense``: ``bns`` float einsums (bf16 operands, f32 sums), or
    ``rns`` / ``sdrns`` on resident expert stacks.  The capacity follows
    the token count, so a prefill must route all its prompts in one call.
    A router with a ``bias`` routes as :func:`route_sigmoid` (gates scaled
    by ``routed_scale``); ``valid (B, S)`` bool with ``n_tokens``, its count,
    keeps padded rows out of the experts (module docstring).  Shared
    experts run where ``params`` has them.
    """
    dkw = dense_kw or {}
    system = dkw.get("system", "bns")
    qkw = {k: dkw[k] for k in ("bits", "mset") if k in dkw}

    def expert_einsum(subscripts, operand, w, out_dtype):
        if system in ("rns", "sdrns") or isinstance(w, (ResidueTensor,
                                                        ShardedParam)):
            out = linear.stacked_qmatmul(subscripts, operand, w,
                                         system=system, **qkw)
        else:
            out = torch.einsum(subscripts, operand.to(torch.float32),
                               w.to(operand.dtype).to(torch.float32))
        return out.to(out_dtype)

    B, S, d = x.shape
    T = B * S
    E, K = n_experts, top_k
    xt = x.reshape(T, d)
    rp = params["router"]
    with tracing.span("moe.route"):
        if "bias" in rp:
            probs, gates, expert_idx = route_sigmoid(
                rp["w"], rp["bias"], xt, K, routed_scale)
        else:
            probs, gates, expert_idx = route(rp["w"], xt, K)
    rows = sharding.dp_rows()
    if valid is not None and (rows is not None or n_tokens is None):
        raise ValueError("valid= needs n_tokens= and no dp row split")
    real = T if valid is None else int(n_tokens)
    C = moe_capacity(real * (rows[2] if rows else 1), E, K, capacity_factor)
    vt = None if valid is None else valid.reshape(T)
    with tracing.span("moe.dispatch"):
        flat_e, pos_in_e, keep = (
            place(expert_idx, E, C, rows) if vt is None else
            place(expert_idx, E, C, rows, valid=vt))
        # slot row in the flattened (E * C, d) buffer; dropped slots go to
        # the spare row E * C, which is cut off
        slot = torch.where(keep, flat_e * C + pos_in_e,
                           torch.full_like(flat_e, E * C))
        src = xt.repeat_interleave(K, dim=0)                  # (T K, d)
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
        buf = buf.index_put((slot,), src)[:E * C].view(E, C, d)
    if tracing.enabled():
        tracing.count("moe.slots", real * K)
        tracing.count("moe.capacity_rows", E * C)
        tracing.count("moe.dropped", real * K - keep.sum())

    def experts(buf, w_gate, w_up, w_down):
        g = expert_einsum("ecd,edf->ecf", buf, w_gate, torch.float32)
        u = expert_einsum("ecd,edf->ecf", buf, w_up, torch.float32)
        h = (F.silu(g) * u).to(x.dtype)
        return expert_einsum("ecf,efd->ecd", h, w_down, x.dtype)

    stacks = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if isinstance(stacks[0], ShardedParam) and stacks[0].tp_dim() == 0:
        # EP: this rank's experts on its block of the buffers
        mesh, tp = stacks[0].ctx.mesh, stacks[0].ctx.tp
        local = [w.gather_dp() for w in stacks]
        with sharding.shard_ctx(None):
            out = experts(coll.diff_slice(buf, 0, mesh, tp), *local)
        out_buf = coll.diff_all_gather(out, 0, mesh, tp)
    else:
        out_buf = experts(buf, *stacks)

    shared = None
    if "shared" in params:
        shared = mlp_mod.swiglu(params["shared"], x, dkw)
    with tracing.span("moe.combine"):
        out_tok = out_buf.reshape(E * C, d)[torch.where(keep, slot, 0)]
        out_tok = torch.where(keep[:, None], out_tok,
                              torch.zeros_like(out_tok))
        y = (out_tok.reshape(T, K, d) * gates.reshape(T, K, 1).to(x.dtype)
             ).sum(dim=1).reshape(B, S, d)
        if shared is not None:
            y = y + shared
    if with_aux:
        return y, _switch_aux(probs, expert_idx, E, rows)
    return y
