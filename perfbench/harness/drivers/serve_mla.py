"""Serving cells of a latent-attention MoE decoder (the ``mla_moe``
family, Moonlight-16B-A3B): the port's request scheduler over the paged
engine, each request retiring on the first token its admission prefill
emits, as the ``serve`` driver runs a dense decoder.

Set-up, the window, the admission wrapper (``serve.Probe``) and the
prefill counts are the ``serve`` driver's.  The traced run also counts
B2's work at its two widths (q and k of ``nope + rope``, v of ``v_head``:
``yardstick/mla.py``) as the op ``flash_attention_mla``.

The check follows the program stage by stage from its own state, as the
``serve`` driver's does, in one admission drawn by the seed.  Besides the
stages' inputs and outputs at the selected rows and every prompt's
attention input, it copies each expert layer's whole input (every real row
of every prompt) and the expert placement the program made for every
(token, slot).  The reference (``reference/moonlight_mla_moe.py``) runs
each stage again from the program's input to it:

* ``chain_err``: the embedding, each layer's input norm and residual adds;
* ``attn_err``: the MLA block (q, ``kv_a``, the latent's norm, ``kv_b``,
  rotary positions on the rope parts, attention over the whole prompt,
  ``wo``) at the selected rows of every prompt;
* ``kv_err``: every prompt's latent page rows after the scatter against
  the reference's quantized latent ``c`` and rotary key ``k_pe``;
* ``mlp_err``: the dense layer's SwiGLU, and each expert layer's routed
  experts plus its shared experts, at the selected rows, routed and placed
  by the reference over the admission's real rows;
* ``head_err``: the final norm and the untied ``lm_head``;
* ``route_diff``: the (token, slot) pairs of the admission's real rows
  whose chosen expert or drop decision differs from the reference's (a
  count; its limit is 0).

The widths are relative gaps as the ``serve`` driver's.  ``control``
takes a run's captures, or (as ``calibrate.py`` calls it) the precision
step and the captures of this process's latest run of the same seed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time

import torch

from harness import main
from harness.capture import Capture
from harness.drivers.serve import Probe, WindowClosed, _csrc, _err, _requests
from harness.main import Cell, Run
from harness.trace import OpTimer, ProfilerSlice, port_kernel_names, span
from yardstick import mla as mla_yard

NUMBERS = ("chain_err", "attn_err", "kv_err", "mlp_err", "head_err",
           "route_diff")

# the latest run's captures, by seed (``control`` as calibrate.py calls it)
_LAST: dict = {}


class MlaCapture(Capture):
    """``harness.capture.Capture`` with two more copies: an expert layer's
    whole input (``x_moe``, every prompt up to the longest) and the
    placement of its (token, slot) pairs (``route``: expert ids and kept
    flags, flattened over the padded batch)."""

    def install(self):
        wrap = {"attention": self._attention, "mlp": self._mlp,
                "place": self._place}
        for kind, (mod_name, attr) in self.targets.items():
            mod = importlib.import_module(mod_name)
            self._orig[kind] = (mod, getattr(mod, attr))
            setattr(mod, attr, wrap[kind])
        return self

    def _mlp(self, params, x, *a, **kw):
        y = super()._mlp(params, x, *a, **kw)
        if self.on and "moe" in params:
            self.layers[-1]["x_moe"] = x[:, : self.sel.n].clone()
        return y

    def _place(self, expert_idx, *a, **kw):
        res = self._orig["place"][1](expert_idx, *a, **kw)
        if self.on:
            flat_e, _, keep = res
            self.layers[-1]["route"] = (flat_e.to(torch.int16).clone(),
                                        keep.clone())
        return res


class SplitOpTimer(OpTimer):
    """``OpTimer`` that also counts each B2 call's work at its two widths,
    as the op ``flash_attention_mla`` on the same events."""

    def __call__(self, op: str, fn, /, *args, **kwargs):
        out = super().__call__(op, fn, *args, **kwargs)
        if self.on and op == "flash_attention":
            _, start, end, _ = self.calls[-1]
            w = _split_work(args, kwargs)
            self.calls.append(("flash_attention_mla", start, end, w))
        return out


def _split_work(args: tuple, kwargs: dict):
    """The split work of one B2 call, read after the window (a length
    tensor copied on its device now)."""
    q, k, v = args[:3]
    kv_len = args[3] if len(args) > 3 else kwargs.get("kv_len")
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.clone()
    shapes = [torch.empty(t.shape, dtype=t.dtype, device="meta")
              for t in (q, k, v)]
    causal = kwargs.get("causal", True)
    return lambda: mla_yard.flash_attention_split_cost(
        *shapes, kv_len, causal=causal)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None, keep: dict | None = None) -> Run:
    """One run of a latent-attention serving cell (``serve.run``'s
    arguments)."""
    from repro_torch.numerics import registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, RequestScheduler

    _LAST.clear()
    cfg, mix, wl = cell.config, cell.mix, cell.workload
    fam, gen = main.family(cell), main.generator(cell)
    if gen.most_new(mix) != 1:
        raise ValueError(f"{cell.name}: the serve_mla driver checks "
                         f"admission prefills only, and its mix decodes")
    port = cfg["port"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parts = {"setup_imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    model = fam.build(cfg, dev)
    params = fam.params(model, cfg, seed, dev)
    engine = ServingEngine(model, params, batch=wl["slots"],
                           s_max=gen.longest(mix),
                           page_size=port["page_size"],
                           kv_format=port["kv_format"], device=dev,
                           **wl.get("engine", {}))
    del params
    sync()
    parts["setup_weights_s"] = time.perf_counter() - t
    if fault is not None:
        fault(engine)
    sched = RequestScheduler(engine)
    timer = SplitOpTimer() if trace and cuda else None
    prof = ProfilerSlice(port_kernel_names(_csrc())) if trace else None
    capture = MlaCapture(fam.CAPTURE).install()
    probe = Probe(engine, seed=seed, seconds=seconds,
                  trace_slice=wl["trace_slice_s"], timer=timer, prof=prof,
                  capture=capture, check=wl["check"])
    vocab = cfg["vocab_size"]
    try:
        t = time.perf_counter()
        sched.serve(_requests(Request, gen.job(
            mix, seed, 0, vocab, tag="warm")[:wl["warm"]["requests"]]))
        sync()
        parts["setup_warm_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start

        probe.measuring = True
        k = 0
        ctx = (timer.installed(registry) if timer is not None
               else contextlib.nullcontext())
        with ctx:
            try:
                while True:
                    reqs = gen.job(mix, seed, k, vocab)
                    with span("serve", prof is not None):
                        sched.serve(_requests(Request, reqs))
                    k += 1
            except WindowClosed:
                pass
    finally:
        capture.uninstall()
    sync()
    window_s = probe.t_close - probe.t_open
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ops = timer.summary() if timer is not None else None
    counts = {**probe.c, **parts}
    counts["model_flops"] = mla_yard.decoder_flops(
        cfg, counts["prompt_tokens"], counts["admitted"])
    counts["captures"] = len(probe.captures)
    captures = probe.captures
    profile = prof.result if prof is not None else None
    # the program's state goes before the reference runs
    del engine, sched, model, probe, timer, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if keep is not None:
        keep["captures"] = captures
    numbers = check(cell, seed, dev, captures)
    _LAST.update(seed=seed, captures=captures)
    return Run(setup_s=setup_s, window_s=window_s,
               attempted=counts["admitted"], failed=0, counts=counts,
               numbers={k: v for k, v in numbers.items()
                        if k in wl["limits"]},
               limits=wl["limits"], memory_peak_bytes=peak, ops=ops,
               profile=profile)


def check(cell: Cell, seed: int, dev, captures: list[dict],
          control: bool = False) -> dict[str, float]:
    """The numbers (module docstring) of the program's captured stages
    against the reference run from the same inputs; with ``control``,
    those of the reference one precision step below, put in the program's
    place, instead."""
    cfg = cell.config
    fam = main.family(cell)
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    hi = ref.CONFIGURED
    lo = ref.CONTROL if control else None
    if not captures:
        return {k: float("inf") for k in NUMBERS}
    errs = {k: 0.0 for k in NUMBERS}

    def note(name, prog, want):
        errs[name] = max(errs[name], _err(prog, want))

    def judge(name, prog, fn, *a):
        note(name, prog if lo is None else fn(lo, *a), fn(hi, *a))

    with torch.no_grad():
        table = fam.embed_table(cfg, seed, dev)
        xs = [table[torch.as_tensor(c["tokens"], device=dev)]
              .to(torch.bfloat16) for c in captures]
        del table
        for li in range(cfg["num_hidden_layers"]):
            w = fam.layer_leaves(cfg, seed, li, dev)
            layers = {p: ref.Served(w, cfg, p) for p in (hi, lo) if p}
            for ci, c in enumerate(captures):
                rec, x = c["layers"][li], xs[ci]
                judge("chain_err", rec["a"], lambda p, v: ref.rmsnorm(
                    v, w["attn_norm"], p), x)
                _attention(cfg, c, li, rec, layers, hi, lo, ref, note)
                judge("chain_err", rec["m"],
                      lambda p, v, h: ref.rnd(v + h, p), x, rec["h"])
                if "x_moe" in rec:
                    _experts(c, rec, layers, hi, lo, ref, note, errs)
                else:
                    judge("mlp_err", rec["y"],
                          lambda p, m: layers[p].mlp(m), rec["m"])
                xs[ci] = ref.rnd(rec["m"] + rec["y"], hi)
            del layers, w
        head = fam.lm_head(cfg, seed, dev)
        final = fam.final_norm(cfg, seed, dev)
        for c, x in zip(captures, xs):
            for j, row in c["logits"].items():
                judge("head_err", torch.as_tensor(row, device=dev)[None],
                      lambda p, v: ref.head(head, final, v, p), x[j:j + 1])
    return errs


def _attention(cfg, c, li, rec, layers, hi, lo, ref, note) -> None:
    """The MLA block's and the latent pages' numbers of one captured layer,
    prompt by prompt (``serve._attention``'s, with the latent ``c`` in the
    K pages and ``k_pe`` in the V pages)."""
    fmt = cfg["port"]["kv_format"]
    for i, n in enumerate(c["lens"]):
        js = [j for j, (b, _) in enumerate(c["pairs"]) if b == i]
        x = rec["x_full"][i, :n]
        rows = torch.as_tensor([c["pairs"][j][1] for j in js],
                               device=x.device)
        h, lat, kpe = layers[hi].attn_prefill(x, rows)
        if lo is None:
            got = (rec["h"][js],
                   ref.page_values(c["k_pages"][i][li], c["k_scale"][i][li],
                                   fmt)[:n],
                   ref.page_values(c["v_pages"][i][li], c["v_scale"][i][li],
                                   fmt)[:n])
        else:
            hl, latl, kpel = layers[lo].attn_prefill(x, rows)
            got = (hl, ref.kv_quant(latl, lo.kv_qmax),
                   ref.kv_quant(kpel, lo.kv_qmax))
        note("attn_err", got[0], h)
        note("kv_err", got[1], ref.kv_quant(lat, hi.kv_qmax))
        note("kv_err", got[2], ref.kv_quant(kpe, hi.kv_qmax))


def _experts(c, rec, layers, hi, lo, ref, note, errs) -> None:
    """An expert layer's numbers: the placement of every real (token,
    slot) pair of the admission against the reference's, and the block's
    output at the selected rows."""
    lens = c["lens"]
    B, S = rec["x_moe"].shape[:2]
    flat = torch.cat([rec["x_moe"][i, :n] for i, n in enumerate(lens)])
    starts = [sum(lens[:i]) for i in range(len(lens))]

    def routing(p):
        L = layers[p]
        D = L.dims
        idx, gates = L.route(flat)
        kept = ref.place(idx, D.experts, ref.capacity(
            flat.shape[0], D.experts, D.top_k, D.cf))
        return idx, gates, kept

    want = routing(hi)
    if lo is None:
        flat_e, kept = rec["route"]
        K = want[0].shape[1]
        prog_e = flat_e.reshape(B, S, K)
        prog_k = kept.reshape(B, S, K)
        got_idx = torch.cat([prog_e[i, :n] for i, n in enumerate(lens)])
        got_keep = torch.cat([prog_k[i, :n] for i, n in enumerate(lens)])
        got = None
    else:
        got_idx, _, got_keep = got = routing(lo)
    diff = (got_idx.to(torch.int64) != want[0]) | (got_keep != want[2])
    errs["route_diff"] += float(diff.sum())
    sel = torch.as_tensor([starts[b] + r for b, r in c["pairs"]],
                          device=flat.device)

    def block(p, routed):
        idx, gates, kept = routed
        return layers[p].moe_rows(rec["m"], idx[sel], gates[sel], kept[sel])

    note("mlp_err", rec["y"] if lo is None else block(lo, got),
         block(hi, want))


def control(cell: Cell, seed: int, dev, captures) -> dict[str, float]:
    """The control's numbers on a run's captures; given an int (the
    precision step, as ``calibrate.py`` passes it), on the captures of this
    process's latest run of ``seed``."""
    if not isinstance(captures, list):
        if _LAST.get("seed") != seed:
            raise ValueError(f"no captures of seed {seed} to judge the "
                             f"control on")
        captures = _LAST.pop("captures")
        _LAST.clear()
    return check(cell, seed, dev, captures, control=True)
