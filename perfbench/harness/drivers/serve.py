"""Serving cells: a decoder served through the port's request scheduler,
each request retiring on the first token its admission prefill emits.

Set-up builds the model through the configuration's family
(``families/<family>.py``), makes its weights from the seed on the device
(one draw a layer, each layer made residue-resident as it is made), builds
the paged engine and its scheduler, and serves a warm job of the cell's own
shapes.

The window is closed-loop: jobs of the mix (``generators/<kind>.py``) go
to ``RequestScheduler.serve`` back to back, each larger than a window can
retire.  The harness wraps the engine's ``admit_prefill``: the wrapper
opens the window at the first admission, counts what each admission does,
and closes the window at the first admission after ``--seconds`` by
raising out of the job.  The driver takes mixes whose budgets are one new
token; a mix that decodes needs a driver that also checks decode steps.

The check follows the program stage by stage from its own state.  With
random weights, int4 activation codes make the decoder chaotic: two sound
implementations that round one product differently serve different
tokens after a few layers (PERF.md), so served tokens cannot be judged
against a reference run of its own.  Instead the harness copies, in one
admission drawn by the seed, what every layer's stages took and gave
(``harness/capture.py``): the attention input of every prompt, and for 17
rows of one prompt drawn by the seed and the last row of every other, the
stages' inputs and outputs; after the admission it copies every prompt's
KV pages and logits.  The reference runs each stage again from the
program's input to it:

* ``chain_err``: the embedding, each layer's input norm and residual adds;
* ``attn_err``: the attention block (q, k, v projections, qk-norm, rotary
  positions, attention over the whole prompt, the output projection), at
  the selected rows of every prompt;
* ``kv_err``: every prompt's page rows after the scatter, against the
  reference's quantized k and v;
* ``mlp_err``: the MLP block;
* ``head_err``: the final norm and the logits.

Each is the widest gap over its stage's values, relative to the largest
reference value of the compared tensor.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time
from pathlib import Path

import numpy as np
import torch

from harness import main, weights
from harness.capture import Capture, Sel
from harness.main import Cell, Run
from harness.trace import OpTimer, ProfilerSlice, port_kernel_names, span
from yardstick import flops

NUMBERS = ("chain_err", "attn_err", "kv_err", "mlp_err", "head_err")


class WindowClosed(Exception):
    """Raised by the wrapped admission at the first boundary after the
    window's end; it ends the job in flight."""


class Probe:
    """The wrapper around the engine's admission (module docstring)."""

    def __init__(self, engine, *, seed: int, seconds: float,
                 trace_slice: float, timer: OpTimer | None,
                 prof: ProfilerSlice | None, capture: Capture, check: dict):
        self.engine, self.seconds = engine, seconds
        self.trace_slice, self.timer, self.prof = trace_slice, timer, prof
        self.capture = capture
        self.rng = np.random.default_rng(weights.block_seed(seed, "check"))
        self.cap_admission = int(self.rng.integers(check["admission"]))
        self.captures: list[dict] = []
        self.measuring = False
        self.t_open = self.t_close = None
        self.c = dict(prompt_tokens=0, prefill_rows=0, admissions=0,
                      admitted=0, admit_s=0.0)
        self._admit = engine.admit_prefill
        engine.admit_prefill = self.admit

    def _open(self) -> None:
        if self.prof is not None:
            self.prof.start()
        if self.timer is not None:
            self.timer.on = True
        self.t_open = time.perf_counter()

    def _boundary(self) -> None:
        if self.t_open is None:
            return
        now = time.perf_counter()
        if self.prof is not None and self.prof.running and (
                now - self.t_open >= min(self.trace_slice, self.seconds)):
            self.prof.stop()
            # the profiler's own stop and reduction are not the window's
            after = time.perf_counter()
            self.t_open += after - now
            now = after
        if now - self.t_open >= self.seconds:
            self.t_close = now
            if self.timer is not None:
                self.timer.on = False
            raise WindowClosed

    def admit(self, slot_tokens, slot_total):
        self._boundary()
        if self.measuring and self.t_open is None:
            self._open()
        counted = self.t_open is not None
        cap = None
        if counted and self.c["admissions"] >= self.cap_admission and \
                not self.captures:
            cap = self._start_capture(slot_tokens)
        t = time.perf_counter()
        with span("admit_prefill", self.prof is not None):
            out = self._admit(slot_tokens, slot_total)
        dt = time.perf_counter() - t
        if cap is not None:
            self._end_capture(cap, out)
        if counted:
            lens = [len(slot_tokens[s]) for s, (_, info) in out.items()
                    if info.cached_logits is None]
            self.c["admit_s"] += dt
            self.c["admissions"] += 1
            self.c["admitted"] += len(out)
            self.c["prompt_tokens"] += sum(lens)
            self.c["prefill_rows"] += len(lens) * max(lens, default=0)
        return out

    def _start_capture(self, slot_tokens) -> dict:
        """Batch row ``i`` of the admission's prefill is the ``i``-th
        slot in order; the seed draws the prompt ``b`` checked at 17
        rows."""
        slots = sorted(slot_tokens)
        lens = [len(slot_tokens[s]) for s in slots]
        b = int(self.rng.integers(len(slots)))
        n = lens[b]
        rows = sorted(set(self.rng.choice(n, size=min(16, n),
                                          replace=False).tolist()) | {n - 1})
        pairs = [(b, r) for r in rows] + [(i, lens[i] - 1)
                                          for i in range(len(slots))
                                          if i != b]
        dev = self.engine.device
        bi = torch.tensor([p[0] for p in pairs], device=dev)
        ri = torch.tensor([p[1] for p in pairs], device=dev)
        layers = self.capture.start(Sel(bi, ri, max(lens)))
        return {"slots": slots, "lens": lens, "pairs": pairs,
                "layers": layers,
                "tokens": [int(slot_tokens[slots[i]][r]) for i, r in pairs]}

    def _end_capture(self, cap, out) -> None:
        self.capture.stop()
        slots, lens = cap["slots"], cap["lens"]
        if any(out[s][1].cached_logits is not None for s in slots):
            return          # a prefix-cache hit: no prefill row to check
        kv = self.engine.pool.kv
        dev = self.engine.device
        pages = [torch.as_tensor(out[s][1].pages, device=dev) for s in slots]
        cap.update(
            k_pages=[kv.k.planes[:, p].clone() for p in pages],
            k_scale=[kv.k.scale[:, p].clone() for p in pages],
            v_pages=[kv.v.planes[:, p].clone() for p in pages],
            v_scale=[kv.v.scale[:, p].clone() for p in pages],
            logits={j: np.asarray(out[slots[i]][0], np.float32)
                    for j, (i, r) in enumerate(cap["pairs"])
                    if r == lens[i] - 1})
        self.captures.append(cap)


def _requests(Request, reqs) -> list:
    return [Request(r.rid, r.tokens, r.max_new) for r in reqs]


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None, keep: dict | None = None) -> Run:
    """One run of a serving cell.  ``fault`` (tests) gets the engine as
    soon as it is built and may break it underneath; ``keep`` (the
    control's readings) receives the captures."""
    from repro_torch.numerics import registry
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, RequestScheduler

    cfg, mix, wl = cell.config, cell.mix, cell.workload
    fam, gen = main.family(cell), main.generator(cell)
    if gen.most_new(mix) != 1:
        raise ValueError(f"{cell.name}: the serve driver checks admission "
                         f"prefills only, and its mix decodes")
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
    timer = OpTimer() if trace and cuda else None
    prof = ProfilerSlice(port_kernel_names(_csrc())) if trace else None
    capture = Capture(fam.CAPTURE).install()
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
    counts["model_flops"] = flops.decoder_flops(
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
    return Run(setup_s=setup_s, window_s=window_s,
               attempted=counts["admitted"], failed=0, counts=counts,
               numbers={k: v for k, v in numbers.items()
                        if k in wl["limits"]},
               limits=wl["limits"], memory_peak_bytes=peak, ops=ops,
               profile=profile)


def _csrc() -> Path:
    import repro_torch
    return Path(repro_torch.__file__).resolve().parent / "csrc"


def _err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    if prog.shape != ref.shape:
        return float("inf")
    scale = float(ref.abs().max())
    return float((prog - ref).abs().max()) / max(scale, 1e-30)


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
        """The reference's ``fn(hi, *a)`` against the program's value, or
        against the control's ``fn(lo, *a)``."""
        note(name, prog if lo is None else fn(lo, *a), fn(hi, *a))

    with torch.no_grad():
        table = fam.embed_table(cfg, seed, dev)
        xs = [table[torch.as_tensor(c["tokens"], device=dev)]
              .to(torch.bfloat16) for c in captures]
        del table
        for li in range(cfg["num_hidden_layers"]):
            w = fam.layer_leaves(cfg, seed, li, dev)
            layers = {p: ref.Layer(w, cfg, p) for p in (hi, lo) if p}
            for ci, c in enumerate(captures):
                rec, x = c["layers"][li], xs[ci]
                judge("chain_err", rec["a"], lambda p, v: ref.rmsnorm(
                    v, w["attn_norm"], p), x)
                _attention(cfg, c, li, rec, layers, hi, lo, ref, note)
                judge("chain_err", rec["m"],
                      lambda p, v, h: ref.rnd(v + h, p), x, rec["h"])
                judge("mlp_err", rec["y"], lambda p, m: layers[p].mlp(m),
                      rec["m"])
                xs[ci] = ref.rnd(rec["m"] + rec["y"], hi)
            del layers, w
        table = fam.embed_table(cfg, seed, dev)
        final = fam.final_norm(cfg, seed, dev)
        for c, x in zip(captures, xs):
            for j, row in c["logits"].items():
                judge("head_err", torch.as_tensor(row, device=dev)[None],
                      lambda p, v: ref.head(table, final, v, p), x[j:j + 1])
    return errs


def _attention(cfg, c, li, rec, layers, hi, lo, ref, note) -> None:
    """The attention block's and the pages' numbers of one captured layer,
    prompt by prompt: the program's output at the prompt's selected rows
    and its page rows against the reference's, or the control's against
    the reference's."""
    fmt = cfg["port"]["kv_format"]
    for i, n in enumerate(c["lens"]):
        js = [j for j, (b, _) in enumerate(c["pairs"]) if b == i]
        x = rec["x_full"][i, :n]
        rows = torch.as_tensor([c["pairs"][j][1] for j in js],
                               device=x.device)
        h, k, v = layers[hi].attn_prefill(x, rows)
        if lo is None:
            got = (rec["h"][js],
                   ref.page_values(c["k_pages"][i][li], c["k_scale"][i][li],
                                   fmt)[:n],
                   ref.page_values(c["v_pages"][i][li], c["v_scale"][i][li],
                                   fmt)[:n])
        else:
            hl, kl, vl = layers[lo].attn_prefill(x, rows)
            got = (hl, ref.kv_quant(kl, lo.kv_qmax),
                   ref.kv_quant(vl, lo.kv_qmax))
        note("attn_err", got[0], h)
        note("kv_err", got[1], ref.kv_quant(k, hi.kv_qmax))
        note("kv_err", got[2], ref.kv_quant(v, hi.kv_qmax))


def control(cell: Cell, seed: int, dev, captures: list[dict]
            ) -> dict[str, float]:
    """The control's numbers on a run's captures."""
    return check(cell, seed, dev, captures, control=True)
