"""Request scheduler: continuous batching over the paged engine.

Port of ``repro/serving/scheduler.py``.  Two modes, picked by the engine:

* **Continuous batching** (``engine.paged``): requests are admitted into
  any free slot *mid-decode*.  The engine decodes in segments that end as
  soon as a slot finishes while requests wait (``stop_on_finish``); the
  scheduler retires that request (its KV pages go back to the pool) and
  admits the next ones into the freed slots with one right-padded prefill
  (``ServingEngine.admit_prefill``).  Ragged prompt lengths and budgets
  share one batch: each slot carries its own position and remaining budget
  into the segment.  Prompts with the same token prefix share KV pages, and
  a page-aligned prompt seen whole before skips its prefill (the pool's
  prefix cache).
* **Fixed rounds** (dense engines): up to ``batch`` requests at a time,
  prompts right-aligned to the round's longest, decoded until every member
  has hit its EOS or budget, then the next round.

Results keep their own lengths; both modes fill the same telemetry fields
of the returned :class:`Request`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.stats import RequestStats, SpecStats

__all__ = ["Request", "RequestScheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new: int
    eos: int | None = None

    result: np.ndarray | None = None   # filled by the scheduler
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)


@dataclasses.dataclass
class _Slot:
    """Host state of one live request slot (continuous mode)."""
    req: Request
    emitted: list[int]            # tokens emitted so far, the first included
    tab: np.ndarray               # (n_pmax,) block-table row
    pages: list[int]              # pages to release at retirement


class RequestScheduler:
    def __init__(self, engine: ServingEngine, *, pad_token: int = 0):
        self.engine = engine
        self.pad = pad_token

    def serve(self, requests: Sequence[Request]) -> list[Request]:
        """Serve every request; returns them by ``rid`` with ``result``
        filled."""
        queue = list(requests)
        done: list[Request] = []
        self._t0 = time.perf_counter()
        if self.engine.paged:
            done = self._serve_continuous(queue)
        else:
            B = self.engine.batch
            while queue:
                round_reqs = queue[:B]
                queue = queue[B:]
                done += self._run_round(round_reqs)
        return sorted(done, key=lambda r: r.rid)

    # -- continuous batching (paged engine) ----------------------------------

    def _serve_continuous(self, queue: list[Request]) -> list[Request]:
        eng = self.engine
        B = eng.batch
        cap = eng.n_pmax * eng.page_size      # KV positions of one slot
        slots: dict[int, _Slot] = {}
        finished: list[Request] = []
        # recompute resume prefixes: the tokens a request had emitted (and
        # trusted) before an unrepairable fault dropped its pages.  At
        # re-admission they ride the prompt through prefill, so the request
        # resumes where it left off.
        resume: dict[int, list[int]] = {}

        def admit(free: list[int]) -> None:
            batch_toks: dict[int, np.ndarray] = {}
            batch_total: dict[int, int] = {}
            pend: dict[int, Request] = {}
            for s in free:
                if not queue:
                    break
                r = queue.pop(0)
                pend[s] = r
                toks = np.asarray(r.tokens, np.int32)
                resumed = resume.get(id(r))
                if resumed:
                    toks = np.concatenate(
                        [toks, np.asarray(resumed, np.int32)])
                batch_toks[s] = toks
                # a verify writes up to k rows past the last emitted one:
                # reserve them (the resumed prefix is part of max_new, so a
                # re-admission needs no more)
                batch_total[s] = min(
                    len(r.tokens) + r.max_new + eng.spec_lookahead, cap)
            if not pend:
                return
            admitted = eng.admit_prefill(batch_toks, batch_total)
            for s, r in pend.items():
                logits, info = admitted[s]
                r.stats.pages_allocated += info.pages_allocated
                r.stats.prefix_hits += info.prefix_hits
                r.stats.prefill_skipped = info.cached_logits is not None
                resumed = resume.pop(id(r), None)
                if resumed is None:
                    emitted = [int(np.argmax(logits))]
                else:
                    # a re-admission's prefill only rebuilt the pages of the
                    # prompt and the trusted prefix.  The next token must
                    # come from a decode step over those (quantized) pages,
                    # as in the clean run, not from the prefill's logits:
                    # the slot is seeded with the prefix and no new token.
                    emitted = list(resumed)
                tok0 = emitted[-1]
                slot = _Slot(req=r, emitted=emitted,
                             tab=eng.pool.tab_row(info.pages, eng.n_pmax),
                             pages=info.pages)
                if (r.eos is not None and tok0 == r.eos) \
                        or len(slot.emitted) >= r.max_new:
                    retire(slot)          # finished on its first token
                else:
                    slots[s] = slot

        def retire(slot: _Slot) -> None:
            r = slot.req
            toks = np.asarray(slot.emitted[: r.max_new], np.int32)
            if r.eos is not None:
                hits = np.nonzero(toks == r.eos)[0]
                if hits.size:
                    toks = toks[: hits[0] + 1]
            r.result = toks
            freed_before = eng.pool.stats.pages_freed
            eng.pool.release(slot.pages)
            r.stats.pages_freed = eng.pool.stats.pages_freed - freed_before
            r.stats.latency_s = time.perf_counter() - self._t0
            finished.append(r)

        while queue or slots:
            free = [s for s in range(B) if s not in slots]
            if queue and free:
                admit(free)
            if not slots:
                continue    # every admitted request finished on its first
            tok0 = np.zeros((B, 1), np.int32)
            pos0 = np.zeros(B, np.int32)
            remaining = np.zeros(B, np.int32)
            eos_vec = np.full(B, -1, np.int64)
            done0 = np.ones(B, bool)
            tabs = np.zeros((B, eng.n_pmax), np.int32)
            for s, sl in slots.items():
                r = sl.req
                tok0[s, 0] = sl.emitted[-1]
                pos0[s] = len(r.tokens) + len(sl.emitted) - 1
                remaining[s] = r.max_new - len(sl.emitted)
                if r.eos is not None:
                    eos_vec[s] = r.eos
                done0[s] = False
                tabs[s] = sl.tab
            res = eng.paged_segment(
                tok0, pos0, remaining, eos_vec, done0, tabs,
                seg=int(remaining.max()), stop_on_finish=bool(queue))
            if res.needs_recompute is not None and res.needs_recompute.any():
                # strict fault policy: these slots held a page that could not
                # be repaired, so their tokens this segment are untrusted.
                # Drop them and the pages (a quarantined page never returns
                # to the free list) and re-admit prompt and trusted prefix
                # through prefill, at the head of the queue.
                for s in list(slots):
                    if not res.needs_recompute[s]:
                        continue
                    sl = slots.pop(s)
                    r = sl.req
                    eng.pool.release(sl.pages)
                    resume[id(r)] = list(sl.emitted)
                    r.stats.recomputes += 1
                    eng.stats.faults.recomputes += 1
                    queue.insert(0, r)
            for s, sl in list(slots.items()):
                r = sl.req
                # speculative segments advance slots by ragged blocks: row s
                # holds counts[s] valid tokens
                take = min(int(res.counts[s]), r.max_new - len(sl.emitted))
                row = res.tokens[s, :take]
                stop = None
                if r.eos is not None:
                    hits = np.nonzero(row == r.eos)[0]
                    if hits.size:
                        stop = int(hits[0]) + 1
                sl.emitted += [int(t) for t in row[:stop]]
                r.stats.decode_steps += res.steps
                r.stats.decode_dispatches += 1
                if res.proposed:
                    # the segment's drafting counters: every co-resident
                    # request rode the same verify steps
                    if r.stats.spec is None:
                        r.stats.spec = SpecStats()
                    r.stats.spec.proposed += res.proposed
                    r.stats.spec.accepted += res.accepted
                    r.stats.spec.emitted += take
                    r.stats.spec.verify_steps += res.steps
                    r.stats.spec.blocks += res.proposed // eng.spec_lookahead
                # the scrub counters cover the pool and the weights: every
                # co-resident request saw (and survived) the same faults
                r.stats.faults_detected += res.faults_detected
                r.stats.faults_corrected += res.faults_corrected
                if stop is not None or len(sl.emitted) >= r.max_new:
                    del slots[s]
                    retire(sl)
        return finished

    # -- fixed rounds (dense engines) ----------------------------------------

    def _run_round(self, reqs: list[Request]) -> list[Request]:
        B = self.engine.batch
        plen = max(len(r.tokens) for r in reqs)
        max_new = max(r.max_new for r in reqs)
        prompts = np.full((B, plen), self.pad, np.int32)
        # the engine stops once every *active* slot has emitted its EOS;
        # unfilled slots are inactive, and a request without an EOS keeps
        # its slot live for the whole round (a negative EOS never matches)
        eos_vec = np.full(B, -1, np.int64)
        active = np.zeros(B, bool)
        for i, r in enumerate(reqs):
            # right-aligned: the last prompt token sits at position plen - 1
            prompts[i, plen - len(r.tokens):] = r.tokens
            active[i] = True
            if r.eos is not None:
                eos_vec[i] = r.eos
        has_eos = any(r.eos is not None for r in reqs)
        out = self.engine.generate({"tokens": prompts}, max_new=max_new,
                                   prompt_len=plen,
                                   eos=eos_vec if has_eos else None,
                                   active=active)
        for i, r in enumerate(reqs):
            toks = out.tokens[i, : r.max_new]
            if r.eos is not None:
                hits = np.nonzero(toks == r.eos)[0]
                if hits.size:
                    toks = toks[: hits[0] + 1]
            r.result = toks
            r.stats.decode_steps = out.steps
            r.stats.decode_dispatches = out.stats.decode_dispatches
            r.stats.pages_allocated = out.stats.pages_allocated
            r.stats.pages_freed = out.stats.pages_freed
            r.stats.faults_detected = out.stats.faults_detected
            r.stats.faults_corrected = out.stats.faults_corrected
            # every member returns at the round's end: a short request waits
            # for the round's longest
            r.stats.latency_s = time.perf_counter() - self._t0
        return reqs
