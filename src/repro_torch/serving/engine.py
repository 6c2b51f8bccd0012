"""Batched serving engine over the paged KV pool.

Port of the paged path of ``repro/serving/engine.py``: ``generate``
prefills right-padded prompts in one pass, scatters the prefill KV into the
page pool (``_scatter``), then runs one decode *segment* and returns a
:class:`GenerateResult`.  The reference runs a segment as one
``lax.while_loop`` dispatch; here it is a plain Python loop of decode steps
(a CUDA graph is later work) with the reference's per-slot ``done`` /
``remaining`` semantics: finished slots keep decoding, and the loop halts
when every slot is done or the segment ends.  The halt test reads one
``(B,)`` bool per step on the host, and only when an ``eos`` is set.
Under ``system="rns"`` the weights are made residue-resident at
construction (``model.prepare_params``).

The fault layer (DESIGN.md §12 and §15) rides on the segment:

* ``policy`` over redundant pages (``kv_format="rns8r"``): every decode
  step also returns the in-kernel per-(slot, layer) syndrome counts, folded
  on the device with ``torch.maximum`` and read by the host once per
  segment.  ``"detect"`` counts them; ``"correct"`` repairs the flagged
  pages (``kv_pages.repair_pages``) and replays the segment from the same
  operands; ``"strict"`` also quarantines pages that fail repair or keep
  re-faulting and recomputes the slots that hold one.
* ``scrub="decode"`` / ``"rotate:k"``: before each segment the redundant
  weight planes (``numerics.api.scrub``) and redundant KV pools
  (``kv_pages.verify_pages``) are checked and repaired; the counts are read
  after the segment.

Greedy decoding takes the ``argmax``; temperature sampling draws from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.api import Model, resolve_device
from repro_torch.numerics import api as nx
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant.residency import map_resident
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.serving.stats import EngineStats, RequestStats

__all__ = ["ServingEngine", "GenerateResult"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, n_emitted) generated ids
    prefill_logits: np.ndarray  # (B, vocab) f32 logits of the prefill pass
    steps: int                  # decode steps executed
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)


class ServingEngine:
    def __init__(self, model: Model, params: Any, *, batch: int, s_max: int,
                 page_size: int = 64, kv_format: str = "bf16",
                 num_pages: int | None = None, cache_dtype=torch.bfloat16,
                 device: torch.device | str = "cuda", scrub: str = "off",
                 policy: str = "off", quarantine_after: int = 3):
        """``kv_format``: ``"bf16"``, ``"rns8"``, ``"rns4"`` or ``"rns8r"``
        page storage.  ``num_pages`` defaults to full capacity for ``batch``
        slots plus the dump page.  ``device`` must be the model's device.

        ``scrub``: ``"off"``, ``"decode"`` (check and repair every
        redundant weight plane and KV pool before each segment) or
        ``"rotate:k"`` (the same units round-robined into ``k`` groups, one
        group per segment).  ``policy``: ``"off"``, ``"detect"``,
        ``"correct"`` or ``"strict"`` escalation of the in-kernel KV
        syndromes (needs ``kv_format="rns8r"``); ``quarantine_after`` is
        the number of faults after which ``"strict"`` retires a page.
        """
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{model.device}")
        self.model = model
        self.device = dev
        self.params = model.prepare_params(params)
        self.batch = batch
        self.s_max = s_max
        self.page_size = page_size
        self.kv_format = kv_format
        self.cache_dtype = cache_dtype
        self.n_pmax = -(-s_max // page_size)
        if num_pages is None:
            num_pages = 1 + batch * self.n_pmax
        cfg = model.cfg
        self.pool = KVPagePool(cfg.n_layers, num_pages, page_size, cfg.n_kv,
                               cfg.hd, fmt=kv_format, dtype=cache_dtype,
                               device=dev)
        self.stats = EngineStats(pool=self.pool.stats)

        self._scrub_groups = 0      # rotate:k group count (0: everything)
        self._scrub_cursor = 0      # the group the next segment checks
        if scrub.startswith("rotate:"):
            self._scrub_groups = int(scrub.split(":", 1)[1])
            if self._scrub_groups < 1:
                raise ValueError(f"scrub rotate group count must be >= 1, "
                                 f"got {scrub!r}")
        elif scrub not in ("off", "decode"):
            raise ValueError(f"scrub must be 'off', 'decode' or 'rotate:k', "
                             f"got {scrub!r}")
        self.scrub = scrub
        self._last_scrub = (0, 0)   # (detected, corrected) of the last pass

        if policy not in ("off", "detect", "correct", "strict"):
            raise ValueError(f"policy must be 'off', 'detect', 'correct' or "
                             f"'strict', got {policy!r}")
        if policy != "off" and not self.pool.fmt.redundant:
            raise ValueError("policy= needs a redundant KV page format "
                             "(kv_format='rns8r'): the in-kernel syndrome "
                             "reads the witness lanes")
        if quarantine_after < 1:
            raise ValueError(f"quarantine_after must be >= 1, got "
                             f"{quarantine_after}")
        self.policy = policy
        self._quarantine_after = quarantine_after
        # repair -> replay rounds per segment before residual faults
        # escalate; a sticky cell re-faults every round, so this also caps
        # the time to quarantine at one segment
        self._fault_max_replays = max(2, quarantine_after)
        self._last_recompute = np.zeros(batch, bool)

    def _scatter(self, k_dense: torch.Tensor, v_dense: torch.Tensor,
                 tab: torch.Tensor) -> None:
        kvp.scatter_prefill(self.pool.kv, k_dense, v_dense, tab,
                            self.page_size)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    # -- redundant-residue scrub ---------------------------------------------

    def _scrub_launch(self) -> list:
        """Check and repair the redundant units due this segment, leaving
        their ``(detected, corrected)`` counts on the device.

        The units are every redundant ``rns`` weight tensor (sorted-key
        tree order) and then the K and V pools; ``rotate:k`` checks the
        units whose number is the cursor modulo ``k``.
        """
        if self.scrub == "off":
            return []
        groups = self._scrub_groups
        active = self._scrub_cursor % groups if groups else 0
        unit = 0
        pending = []
        scrubbed = {"w": False}

        def due() -> bool:
            nonlocal unit
            mine = not groups or unit % groups == active
            unit += 1
            return mine

        def fix(t: ResidueTensor):
            if t.layout == "rns" and t.mset.redundant and due():
                t, d, c = nx.scrub(t, sync=False)
                pending.append((d, c))
                scrubbed["w"] = True
            return t

        self.params = map_resident(self.params, fix)
        if scrubbed["w"]:
            self.stats.faults.weight_scrubs += 1
        if self.pool.fmt.redundant:
            scrubbed_kv = False
            for t in self.pool.kv:
                if due():
                    _, d, c = kvp.verify_pages(t, sync=False)
                    pending.append((d, c))
                    scrubbed_kv = True
            if scrubbed_kv:
                self.stats.faults.kv_scrubs += 1
        if groups:
            self._scrub_cursor += 1
        return pending

    def _drain_scrub(self, pending: list) -> tuple[int, int]:
        """Read the launched scrub counts and fold them into the stats."""
        det = sum(int(d) for d, _ in pending)
        cor = sum(int(c) for _, c in pending)
        self.stats.faults.detected += det
        self.stats.faults.corrected += cor
        return det, cor

    # -- the decode segment --------------------------------------------------

    @staticmethod
    def _eos_hit(tok: torch.Tensor, eos: torch.Tensor) -> np.ndarray:
        """(B,) host bools: which slots just emitted their EOS."""
        return ((eos >= 0) & (tok[:, 0] == eos)).cpu().numpy()

    def _run_segment(self, tok0, tab, pos0, eos_np, eos, done_in, remaining,
                     seg, temperature, generator):
        """Decode from ``tok0`` (already emitted) at per-slot positions
        ``pos0 + i``; step ``i`` samples the segment's token ``i``.

        Returns ``(buf (B, n) device tokens, n, done (B,) host bools, syn)``,
        with ``syn`` the ``(B, L)`` device map of syndrome counts folded
        over the steps by ``torch.maximum`` (a fault read by every step
        counts once), or None without a policy.
        """
        B = tok0.shape[0]
        with_syn = self.policy != "off"
        watch = bool((eos_np >= 0).any())
        done = np.asarray(done_in, bool) | (remaining <= 0)
        if watch:
            done = done | self._eos_hit(tok0, eos)
        syn = (torch.zeros((B, self.model.cfg.n_layers), dtype=torch.int32,
                           device=self.device) if with_syn else None)
        toks, tok, i = [], tok0, 0
        halt = bool(done.all()) or seg <= 0
        while not halt:
            out = self.model.decode_paged(
                self.params, tok, self.pool.kv, tab, pos0 + i,
                page_size=self.page_size, cache_dtype=self.cache_dtype,
                with_syndrome=with_syn)
            if with_syn:
                logits, _, syn_i = out
                syn = torch.maximum(syn, syn_i)
            else:
                logits, _ = out
            tok = self._sample(logits, temperature, generator)
            toks.append(tok)
            if watch:
                done = done | self._eos_hit(tok, eos)
            done = done | (i + 1 >= remaining)
            i += 1
            halt = bool(done.all()) or i >= seg
        buf = (torch.cat(toks, dim=1) if toks else
               torch.zeros((B, 0), dtype=torch.long, device=self.device))
        return buf, i, done, syn

    def _dispatch_segment(self, tok0, pos0, eos_vec, done0, remaining, tabs,
                          seg, temperature, generator):
        """Run one decode segment under the scrub and the fault policy.

        ``tok0 (B, 1)`` device tokens already emitted; ``pos0``,
        ``remaining``, ``done0``, ``eos_vec`` and ``tabs (B, n_pmax)`` are
        host arrays.  Returns ``(tokens (B, n) host, steps, done (B,))``.
        The fault-injection harness (``testing/faults.py``) wraps this
        method.
        """
        tabs = np.asarray(tabs, np.int32)
        eos_np = np.asarray(eos_vec, np.int64)
        dev = self.device
        tab_dev = torch.as_tensor(tabs, device=dev)
        pos_dev = torch.as_tensor(np.asarray(pos0, np.int32), device=dev)
        eos_dev = torch.as_tensor(np.clip(eos_np, -1, 2**31 - 1), device=dev)
        remaining = np.asarray(remaining, np.int64)
        pending = self._scrub_launch()
        g_state = None if generator is None else generator.get_state()

        def run_once():
            # the same operands every time, the sampler's state included:
            # after an in-place page repair a replay recomputes the segment
            # as a fault-free run would (the first run's tokens are
            # untrusted once a syndrome fired)
            if g_state is not None:
                generator.set_state(g_state)
            return self._run_segment(tok0, tab_dev, pos_dev, eos_np, eos_dev,
                                     done0, remaining, seg, temperature,
                                     generator)

        buf, n, done, syn = run_once()
        self._last_scrub = self._drain_scrub(pending)
        if self.policy != "off":
            buf, n, done, recompute = self._fault_escalate(run_once, buf, n,
                                                           done, syn, tabs)
        else:
            recompute = np.zeros(tok0.shape[0], bool)
        self._last_recompute = recompute
        self.stats.decode_steps += n
        self.stats.decode_dispatches += n
        return buf.cpu().numpy(), n, done

    # -- fault escalation ----------------------------------------------------

    def _fault_repair(self, layers, tabs_np, slots) -> dict[int, list[int]]:
        """Repair the pages the flagged slots hold, at the flagged layers,
        in both pools (``kv_pages.repair_pages``).  Folds the element counts
        into ``stats.faults`` and returns ``{page: [detected,
        uncorrectable]}`` for the pages that showed a fault.  (The fault
        injection harness wraps this method to model sticky cells.)"""
        pages = sorted({int(p) for s in slots for p in tabs_np[s] if p})
        layers = sorted(int(la) for la in layers)
        ledger: dict[int, list[int]] = {}
        if not pages or not layers:
            return ledger
        f = self.stats.faults
        for t in self.pool.kv:
            _, det, cor, unc = kvp.repair_pages(t, layers, pages)
            f.detected += int(det.sum())
            f.corrected += int(cor.sum())
            f.uncorrected += int(unc.sum())
            page_det, page_unc = det.sum(axis=0), unc.sum(axis=0)
            for i, pid in enumerate(pages):
                if page_det[i]:
                    rec = ledger.setdefault(pid, [0, 0])
                    rec[0] += int(page_det[i])
                    rec[1] += int(page_unc[i])
        return ledger

    def _fault_escalate(self, run_once, buf, n, done, syn, tabs_np):
        """Escalate a segment's nonzero syndromes: detect -> correct ->
        quarantine -> recompute.

        ``syn`` is the ``(B, L)`` per-(slot, layer) map, read here once.
        Each round repairs the flagged slots' pages at the flagged layers,
        strikes each faulty page (``pool.note_fault``), quarantines pages
        that failed repair or reached ``quarantine_after`` strikes, and
        replays the segment.  Under ``"strict"`` slots that hold a
        quarantined page, or stay dirty after ``_fault_max_replays``
        rounds, are flagged for recompute.
        """
        pool, f = self.pool, self.stats.faults
        B = tabs_np.shape[0]
        recompute = np.zeros(B, bool)
        syn_np = syn.cpu().numpy()
        total = int(syn_np.sum())
        if total == 0:
            return buf, n, done, recompute
        f.syndromes += total
        if self.policy == "detect":
            return buf, n, done, recompute
        replays = 0
        while True:
            flagged = [s for s in np.nonzero(syn_np.sum(axis=1))[0]
                       if not recompute[s]]
            if not flagged:
                break
            layers = np.nonzero(syn_np.sum(axis=0))[0]
            ledger = self._fault_repair(layers, tabs_np, flagged)
            for pid, (_, unc) in sorted(ledger.items()):
                strikes = pool.note_fault(pid)
                if unc or strikes >= self._quarantine_after:
                    if pool.quarantine(pid):
                        f.pages_quarantined += 1
                        logger.warning(
                            "KV page %d quarantined (%d strike(s), %d "
                            "uncorrectable element(s))", pid, strikes, unc)
                    if self.policy == "strict":
                        recompute |= (tabs_np == pid).any(axis=1)
            if recompute.all():
                break
            if replays >= self._fault_max_replays:
                # repairs did not stick within the round budget: never emit
                # these slots' tokens under "strict"
                if self.policy == "strict":
                    recompute[flagged] = True
                break
            buf, n, done, syn = run_once()
            f.replays += 1
            replays += 1
            syn_np = syn.cpu().numpy()
            fresh = int(syn_np.sum())
            if fresh == 0:
                break
            f.syndromes += fresh
        return buf, n, done, recompute

    # -- generate ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, batch_inputs: dict[str, Any], *, max_new: int,
                 prompt_len: int | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 eos: int | np.ndarray | None = None,
                 active: np.ndarray | None = None) -> GenerateResult:
        """Prefill ``batch_inputs["tokens"]`` (B, S), then decode up to
        ``max_new`` tokens per slot (the first comes from the prefill).

        ``prompt_len``: position of the first generated token (the prompt
        length by default).  ``eos``: a scalar or per-slot ``(B,)`` stop
        token (negative entries never match); decoding halts once every
        slot is done, and slots marked False in ``active`` count as done
        from the start.  Without ``eos`` every slot runs ``max_new``.
        """
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]),
                                 device=self.device).long()
        B, S = tokens.shape
        plen = S if prompt_len is None else int(prompt_len)
        if B > self.batch:
            raise ValueError(f"{B} prompts for an engine of batch "
                             f"{self.batch}")
        if plen + max_new > self.s_max:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"s_max {self.s_max}")
        if eos is not None:
            eos_vec = np.broadcast_to(np.asarray(eos, np.int64), (B,))
            done0 = (np.zeros(B, bool) if active is None
                     else ~np.asarray(active, bool))
        else:
            eos_vec = np.full(B, -1, np.int64)
            done0 = np.zeros(B, bool)
        t0 = time.perf_counter()
        logits, (k_dense, v_dense) = self.model.prefill(
            self.params, tokens, s_max=self.s_max,
            cache_dtype=self.cache_dtype)
        prefill_logits = logits.to(torch.float32).cpu().numpy()
        t1 = time.perf_counter()
        tok = self._sample(logits, temperature, generator)

        pool = self.pool
        pool.reset()    # generate() owns the whole pool for this call
        a0 = pool.stats.snapshot()
        n_pages = min(-(-(plen + max_new) // self.page_size), self.n_pmax)

        def place(dense):
            """Fresh pages for every slot, with the prefill KV ``dense``
            scattered into them."""
            slot_pages = [pool.alloc(n_pages) for _ in range(B)]
            tabs = np.stack([pool.tab_row(p, self.n_pmax)
                             for p in slot_pages])
            self._scatter(*dense, torch.as_tensor(tabs, device=self.device))
            return slot_pages, tabs

        dense = (k_dense, v_dense)
        del k_dense, v_dense
        slot_pages, tabs = place(dense)
        if self.policy != "strict":
            dense = None    # only a strict recompute scatters it again
        g_state = None if generator is None else generator.get_state()
        recomputes = 0
        while True:
            buf, steps, _ = self._dispatch_segment(
                tok, np.full(B, plen, np.int32), eos_vec, done0,
                np.full(B, max_new - 1, np.int64), tabs, max_new - 1,
                temperature, generator)
            if not (self.policy == "strict" and self._last_recompute.any()
                    and recomputes < 2):
                break
            # slots held an unrepairable (now quarantined) page: release
            # everything, re-allocate from the shrunk free list, re-scatter
            # the prefill cache and decode the whole segment again
            n_re = int(self._last_recompute.sum())
            recomputes += n_re
            self.stats.faults.recomputes += n_re
            for p in slot_pages:
                pool.release(p)
            slot_pages, tabs = place(dense)
            if g_state is not None:
                generator.set_state(g_state)
        tokens_np = np.concatenate([tok.cpu().numpy(), buf], axis=1)
        t2 = time.perf_counter()
        for p in slot_pages:
            pool.release(p)
        f_det, f_cor = self._last_scrub
        return GenerateResult(
            tokens=tokens_np, prefill_logits=prefill_logits, steps=steps,
            stats=RequestStats(
                decode_steps=steps, decode_dispatches=steps,
                pages_allocated=pool.stats.pages_allocated
                - a0.pages_allocated,
                pages_freed=pool.stats.pages_freed - a0.pages_freed,
                prefill_s=t1 - t0, decode_s=t2 - t1,
                faults_detected=f_det, faults_corrected=f_cor,
                recomputes=recomputes))
