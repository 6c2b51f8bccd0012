"""Drafters for the speculative serving loop.

Port of ``repro/serving/drafters.py``: two drafters behind one protocol.

* :class:`NGramDrafter` -- model-free lookahead.  Each slot's token stream
  (prompt and emitted tokens) lives in a device history buffer; the drafter
  proposes the continuation of the most recent earlier occurrence of the
  last ``n`` tokens.
* :class:`RNSDraftModel` -- a reduced-moduli residue model derived from the
  target's own resident planes (no second checkpoint): each weight is
  decoded back to its quantized values and re-encoded through a cheaper
  set, by default P16 = (31, 32, 33) at 3 bits against the target's P21
  at 4.  It decodes through its own bf16 shadow page pool, indexed by the
  target's page ids and block tables: page bytes are a function of the
  token prefix per model, so the draft KV of a slot sits where the
  target's does.

The protocol, on plain device tensors (``state`` is a dict the engine
keeps between calls):

* ``init_state(batch)`` -- the state for a new batch;
* ``begin(state, slot_tokens, slot_tok0, prompts, tabs, s_max)`` -- at
  admission, on the host: register the admitted slots' prompts (the rns
  drafter prefills ``prompts``, one row an admitted prompt, and scatters
  them through ``tabs``; ``prompts`` None when every prefill was skipped);
* ``propose(state, tok, pos, tab) -> (drafts (B, k), state)``;
* ``observe(state, block, m, pos, tab) -> state`` -- the accepted block
  (``m`` tokens a slot, 0 for dead slots) was just emitted.

Neither drafter samples, so neither takes a random generator.
"""
from __future__ import annotations

import torch

from repro_torch.core.moduli import P16, ModuliSet
from repro_torch.models.api import Model, build_model
from repro_torch.numerics import api as nx
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant import residency
from repro_torch.serving.spec import SpecConfig

__all__ = ["NGramDrafter", "RNSDraftModel", "derive_draft_params",
           "make_drafter"]


class NGramDrafter:
    """Model-free n-gram lookahead drafter.

    ``hist (B, cap + 1)`` holds each slot's token stream; index ``pos`` (the
    engine's per-slot position of the current last token) is its last valid
    entry.  Column ``cap`` takes the writes :meth:`observe` makes past the
    history (the reference drops them) and is never read.
    """

    def __init__(self, k: int, *, n: int = 2, hist_cap: int,
                 device: torch.device | str = "cuda"):
        self.k = k
        self.n = n
        self.cap = hist_cap + k + 1
        self.device = torch.device(device)

    def init_state(self, batch: int) -> dict:
        return {"hist": torch.zeros((batch, self.cap + 1), dtype=torch.long,
                                    device=self.device)}

    def begin(self, state, slot_tokens, slot_tok0, prompts, tabs, s_max):
        hist = state["hist"]
        for s, toks in slot_tokens.items():
            toks = torch.as_tensor(toks, dtype=torch.long)
            row = torch.zeros(self.cap + 1, dtype=torch.long)
            row[: len(toks)] = toks
            row[len(toks)] = int(slot_tok0[s])
            hist[s] = row.to(self.device)
        return state

    def propose(self, state, tok, pos, tab):
        n, k, cap = self.n, self.k, self.cap
        hist = state["hist"][:, :cap]
        dev = hist.device
        pos = pos.to(device=dev, dtype=torch.long)
        # the n-token context ending at pos (clamped gathers; contexts that
        # would start before the stream are masked below)
        ctx = hist.gather(1, (pos[:, None] - (n - 1) + torch.arange(
            n, device=dev)[None, :]).clamp(0, cap - 1))             # (B, n)
        win = hist.unfold(1, n, 1)                       # (B, cap - n + 1, n)
        j = torch.arange(cap - n + 1, device=dev)[None, :]
        # a usable match ends strictly before the current last token (so it
        # has a continuation), and the context itself must exist
        valid = (j + n <= pos[:, None]) & (pos[:, None] >= n - 1)
        hit = (win == ctx[:, None, :]).all(dim=-1) & valid
        best = torch.where(hit, j, -1).amax(dim=1)                  # (B,)
        # continuation tokens after the matched window, within the known
        # stream; otherwise (no match, or off the end) the slot's current
        # last token again
        last = hist.gather(1, pos.clamp(0, cap - 1)[:, None])       # (B, 1)
        src = best[:, None] + n + torch.arange(k, device=dev)[None, :]
        in_range = (best >= 0)[:, None] & (src <= pos[:, None])
        drafts = torch.where(in_range, hist.gather(1, src.clamp(0, cap - 1)),
                             last)
        return drafts, state

    def observe(self, state, block, m, pos, tab):
        hist = state["hist"]
        dev = hist.device
        j = torch.arange(block.shape[1], device=dev)[None, :]
        # emitted token j lands at stream index pos + 1 + j; dead slots
        # (m == 0), the rejected tail and writes past the history go to the
        # spare column
        idx = torch.where(j < m.to(dev)[:, None],
                          pos.to(device=dev, dtype=torch.long)[:, None] + 1
                          + j, self.cap).clamp(max=self.cap)
        hist.scatter_(1, idx, block.to(device=dev, dtype=torch.long))
        return state


def derive_draft_params(params, draft_model: Model):
    """Draft weights from the target's resident tree, one weight at a time.

    Each :class:`ResidueTensor` is decoded to its quantized values times
    its scale (f32; a float weight of a bns target, picked by
    ``residency.makes_resident`` as ``prepare_params`` picks it, is taken
    as it is), re-encoded through ``draft_model.prepare_weight``, and the
    float copy freed before the next, so the transient is one weight, not
    the tree.  Float leaves (norm scales, the embedding table, a moe
    router) are shared with the target, not copied.  The draft's tied
    logits weight is made from the float table, as the reference's is (the
    target's ``logits_w`` is not decoded).
    """
    def weight(w):
        # a resident weight decoded, or a float weight of a bns target
        if isinstance(w, ResidueTensor):
            w = nx.decode(w)
        return draft_model.prepare_weight(w)

    def walk(node, name=None):
        if isinstance(node, ResidueTensor):
            return weight(node)
        if residency.makes_resident(name, node):
            return ({"w": weight(node["w"])} if isinstance(node, dict)
                    else weight(node))
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, k) for k, v in node.items()
               if not (name == "embed" and k == "logits_w")}
        if name == "embed":
            out["logits_w"] = draft_model.prepare_weight(
                node["table"].to(torch.float32).T)
        return out

    with torch.no_grad():
        return {k: walk(v, k) for k, v in params.items()}


class RNSDraftModel:
    """Reduced-moduli residue draft model sharing the target's weights.

    ``propose`` runs ``k + 1`` draft decode steps in a Python loop, one per
    proposed token and one more that only writes the last proposal's KV
    row, so a fully accepted block leaves no hole in the draft cache.  The
    shadow pool takes the target's block tables as they are; rejected rows
    are overwritten by the next propose at the same positions, so
    ``observe`` does nothing.
    """

    def __init__(self, k: int, target: Model, target_params, *,
                 qbits: int = 3, mset: ModuliSet | None = None,
                 num_pages: int, page_size: int,
                 cache_dtype=torch.bfloat16):
        self.k = k
        self.mset = P16 if mset is None else mset
        self.model = build_model(target.cfg, system="rns", rns_bits=qbits,
                                 rns_mset=self.mset, device=target.device)
        self.params = derive_draft_params(target_params, self.model)
        self.page_size = page_size
        self.cache_dtype = cache_dtype
        cfg = target.cfg
        self.kv = kvp.make_paged_kv(cfg.n_layers, num_pages, page_size,
                                    cfg.n_kv, cfg.hd, dtype=cache_dtype,
                                    device=target.device)

    def init_state(self, batch: int) -> dict:
        # one shadow pool for the engine's lifetime: every row a verify can
        # read is written before it is read, as in the target's pool
        return {"kv": self.kv}

    def begin(self, state, slot_tokens, slot_tok0, prompts, tabs, s_max):
        if prompts is None:      # every admitted prompt's prefill was
            return state         # skipped: its shadow pages hold its KV
        _, cache = self.model.prefill(self.params, prompts, s_max=s_max,
                                      cache_dtype=self.cache_dtype)
        kvp.scatter_prefill(state["kv"], cache[0], cache[1], tabs,
                            self.page_size)
        return state

    def propose(self, state, tok, pos, tab):
        drafts, cur = [], tok
        for j in range(self.k + 1):
            logits, _ = self.model.decode_paged(
                self.params, cur, state["kv"], tab, pos + j,
                page_size=self.page_size, cache_dtype=self.cache_dtype)
            cur = torch.argmax(logits, dim=-1)[:, None]
            if j < self.k:
                drafts.append(cur)
        return torch.cat(drafts, dim=1), state

    def observe(self, state, block, m, pos, tab):
        return state


def make_drafter(cfg: SpecConfig, target: Model, target_params, *,
                 num_pages: int, page_size: int, n_pmax: int,
                 cache_dtype=torch.bfloat16):
    """The drafter a parsed ``spec=`` knob names."""
    if cfg.drafter == "ngram":
        return NGramDrafter(cfg.k, n=cfg.ngram_n, hist_cap=n_pmax * page_size,
                            device=target.device)
    return RNSDraftModel(cfg.k, target, target_params, qbits=cfg.draft_qbits,
                         mset=cfg.draft_mset, num_pages=num_pages,
                         page_size=page_size, cache_dtype=cache_dtype)
