"""Batched serving engine over the paged KV pool or the dense cache.

Port of the paged and the dense paths of ``repro/serving/engine.py``.
``paged=None`` (the default) serves from the page pool where the model has
a paged decode (the dense, moe and vlm families) and from the dense cache
otherwise (the hybrid and audio families; the ssm family from its SSM
state alone, no KV); ``paged=False`` pins the dense cache.

Paged: ``generate`` prefills right-padded prompts in one pass, scatters
the prefill KV into the page pool (``_scatter``), then runs one decode
*segment* and returns a :class:`GenerateResult`.  The reference runs a
segment as one ``lax.while_loop`` dispatch; here it is a plain Python loop
of decode steps (a CUDA graph is later work) with the reference's per-slot
``done`` / ``remaining`` semantics: finished slots keep decoding, and the
loop halts when every slot is done or the segment ends.  The halt test
reads one ``(B,)`` bool per step on the host, and only when an ``eos`` is
set.  Under ``system="rns"`` the weights are made residue-resident at
construction (``model.prepare_params``); ``prepare=False`` keeps float
weights on the per-call path (quantized and converted at every matmul),
the baseline the resident path is measured against, with the same
tokens.

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

Continuous batching (``serving/scheduler.py``) drives the paged pool
through :meth:`ServingEngine.admit_prefill` (pages from the pool's prefix
cache, one right-padded prefill over the admitted prompts that need one)
and :meth:`ServingEngine.paged_segment` (one segment at per-slot positions
and budgets, ended early by ``stop_on_finish`` when a slot finishes while
requests wait).  ``generate`` resets the pool and owns it for the call; the
scheduler never calls it in continuous mode.

Speculative decoding (``spec="ngram:k"`` / ``"rns:k"``, paged and greedy
only, no ``policy``): a drafter (``serving/drafters.py``) proposes ``k``
tokens a slot, the target verifies them with its current token in one
batched ``verify_paged`` step (``k + 1`` rows a slot, one folded paged
decode launch a layer), and the greedy rule (``serving/spec.py``) emits the
longest agreed prefix plus the target's next token.  Slots advance by
ragged blocks; the tokens equal plain greedy decoding.  The pages get
``k`` positions of headroom for the verify's overshoot.  The loop reads the
device once a verify step, for the halt test.

Dense: ``generate`` keeps the cache the prefill made (KV padded to
``s_max``, and the ssm and hybrid families' SSM state) and decodes every slot at
the uniform position ``prompt_len + i``, one ``model.decode`` per token, in
the reference's host loop (its fused ``while_loop`` is that loop's twin):
each token is emitted, then the ``eos`` / ``active`` mask is updated, and
the loop stops once every slot is done or ``max_new`` tokens are out.  No
pool is built, so ``kv_format`` is ignored; a ``policy`` needs pages and
raises; ``scrub`` still checks the weight planes before the loop.

Greedy decoding takes the ``argmax``; temperature sampling draws from a
``torch.Generator``.

Under an installed :class:`~repro_torch.parallel.sharding.ShardCtx` (a
mesh) the engine serves from the dense cache, as the reference's does: the
page pool is off and ``spec=`` is refused.  The weights come out of
``prepare_params`` as this rank's blocks, and the runners' plans carry the
matmuls; ``stats.fallback_gathers`` counts the channel-split plans that
fell back to the gathered layout since the engine was made.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models.api import Model, resolve_device
from repro_torch.models.transformer import kv_dims
from repro_torch.numerics import api as nx
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics import runners
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.parallel.sharding import get_shard_ctx
from repro_torch.quant.residency import map_resident
from repro_torch.serving.drafters import make_drafter
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.serving.spec import SpecConfig, accept_blocks
from repro_torch.serving.stats import EngineStats, RequestStats, SpecStats

__all__ = ["ServingEngine", "GenerateResult", "SegmentResult"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, n_emitted) generated ids
    prefill_logits: np.ndarray  # (B, vocab) f32 logits of the prefill pass
    steps: int                  # decode steps executed
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)


@dataclasses.dataclass
class SegmentResult:
    """One decode segment of the continuous scheduler."""
    tokens: np.ndarray   # (B, n) tokens emitted this segment, all slots
    steps: int           # decode (or verify) steps executed
    done: np.ndarray     # (B,) bool: which slots had finished at exit
    faults_detected: int = 0   # scrub detections before this segment
    faults_corrected: int = 0  # ... repaired before it ran
    # per-slot emitted counts: under speculative decoding slots advance by
    # ragged accepted blocks, so row s holds counts[s] valid tokens (plain
    # segments fill it with ``steps``)
    counts: np.ndarray | None = None
    proposed: int = 0    # draft tokens proposed this segment (spec only)
    accepted: int = 0    # ... accepted by the greedy rule
    # (B,) bool under policy="strict": slots that hold an unrepairable page;
    # their tokens this segment are untrusted and the scheduler re-admits
    # the request (prompt and trusted tokens) through prefill
    needs_recompute: np.ndarray | None = None


class ServingEngine:
    def __init__(self, model: Model, params: Any, *, batch: int, s_max: int,
                 page_size: int = 64, kv_format: str = "bf16",
                 num_pages: int | None = None, cache_dtype=torch.bfloat16,
                 device: torch.device | str = "cuda", scrub: str = "off",
                 policy: str = "off", quarantine_after: int = 3,
                 paged: bool | None = None, spec=None,
                 prefix_cache: bool = True, prepare: bool = True):
        """``paged``: ``None`` serves from the page pool when the model has
        a paged decode, else from the dense cache; ``False`` pins the
        dense cache (a ``True`` the model cannot serve falls back to it,
        as in the reference).  ``kv_format``: ``"bf16"``, ``"rns8"``,
        ``"rns4"`` or ``"rns8r"`` page storage (paged only).
        ``num_pages`` defaults to full capacity for ``batch`` slots plus
        the dump page.  ``device`` must be the model's device.
        ``prefix_cache``: prompt pages shared between requests with the
        same token prefix, and prefill skipped for a page-aligned prompt
        seen whole before, on the scheduler's admission path
        (:meth:`admit_prefill`).

        ``scrub``: ``"off"``, ``"decode"`` (check and repair every
        redundant weight plane and KV pool before each segment) or
        ``"rotate:k"`` (the same units round-robined into ``k`` groups, one
        group per segment).  ``policy``: ``"off"``, ``"detect"``,
        ``"correct"`` or ``"strict"`` escalation of the in-kernel KV
        syndromes (needs ``kv_format="rns8r"``); ``quarantine_after`` is
        the number of faults after which ``"strict"`` retires a page.

        ``prepare``: make the weights residue-resident up front (the
        default; identity under ``bns``), or keep float weights and
        quantize and convert them at every matmul (the per-call path: the
        same tokens, a baseline for the conversion's cost).

        ``spec``: speculative decoding, a :class:`SpecConfig` or a
        ``"ngram"`` / ``"ngram:k"`` / ``"rns"`` / ``"rns:k"`` string (module
        docstring).  It needs paged serving, greedy sampling and
        ``policy="off"``; the ``rns`` drafter derives its draft weights
        from this engine's resident ones here.

        Under a shard context paged serving is off (the dense cache serves)
        and ``spec`` is refused.
        """
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{model.device}")
        self.model = model
        self.device = dev
        self.params = model.prepare_params(params) if prepare else params
        self.prepared = prepare
        self.batch = batch
        self.s_max = s_max
        self.page_size = page_size
        self.kv_format = kv_format
        self.cache_dtype = cache_dtype
        # baseline of the process-lifetime fallback counter
        self._fallback_base = runners.fallback_gather_count()
        mesh = get_shard_ctx() is not None
        supported = model.decode_paged is not None and not mesh
        if paged is None:
            paged = supported
        elif paged and not supported:
            logger.info("paged serving unsupported here (family %s, mesh "
                        "%s): serving from the dense cache",
                        model.cfg.family, mesh)
            paged = False
        self.paged = paged
        self.pool = None
        self.stats = EngineStats()
        if paged:
            self.n_pmax = -(-s_max // page_size)
            if num_pages is None:
                num_pages = 1 + batch * self.n_pmax
            cfg = model.cfg
            n_kv, hk, hv = kv_dims(cfg)
            self.pool = KVPagePool(cfg.n_layers, num_pages, page_size,
                                   n_kv, hk, fmt=kv_format,
                                   dtype=cache_dtype, device=dev,
                                   prefix_cache=prefix_cache, v_head_dim=hv)
            self.stats.pool = self.pool.stats

        self.spec = None
        self._drafter = None
        if spec is not None:
            if mesh:
                raise ValueError("spec= is not supported under a mesh (the "
                                 "engine serves from the dense cache "
                                 "there)")
            if not self.paged:
                raise ValueError("spec= needs paged serving (a family with a "
                                 "paged decode, and paged not False)")
            if policy != "off":
                raise ValueError("policy= is not supported with speculative "
                                 "decoding (the verify step is syndrome-free)")
            self.spec = SpecConfig.parse(spec)
            self._drafter = make_drafter(
                self.spec, model, self.params, num_pages=self.pool.num_pages,
                page_size=page_size, n_pmax=self.n_pmax,
                cache_dtype=cache_dtype)
            self._spec_state = self._drafter.init_state(batch)
            self.stats.spec = SpecStats()

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
        if policy != "off" and not (self.paged and self.pool.fmt.redundant):
            raise ValueError("policy= needs paged serving with a redundant "
                             "KV page format (kv_format='rns8r'): the "
                             "in-kernel syndrome reads the witness lanes")
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
        with tracing.span("engine.scatter"):
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
        if self.pool is not None and self.pool.fmt.redundant:
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
                     seg, temperature, generator, stop_on_finish=False):
        """Decode from ``tok0`` (already emitted) at per-slot positions
        ``pos0 + i``; step ``i`` samples the segment's token ``i``.
        ``stop_on_finish`` ends the segment after the first step in which
        a slot newly finishes (the scheduler then admits into it).

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
        fin0 = done
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
            halt = (bool(done.all()) or i >= seg
                    or (stop_on_finish and bool((done & ~fin0).any())))
        buf = (torch.cat(toks, dim=1) if toks else
               torch.zeros((B, 0), dtype=torch.long, device=self.device))
        return buf, i, done, syn

    def _dispatch_segment(self, tok0, pos0, eos_vec, done0, remaining, tabs,
                          seg, temperature, generator, stop_on_finish=False):
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
                                     generator, stop_on_finish)

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

    # -- the speculative segment ---------------------------------------------

    def _spec_begin(self, slot_tokens: dict, slot_tok0: dict, prompts,
                    tabs, s_max: int) -> None:
        """Register newly admitted prompts with the drafter (spec= only):
        the n-gram drafter seeds those slots' history rows, the rns drafter
        prefills ``prompts`` and scatters its shadow pages through ``tabs``
        (``prompts`` None: every prefill was skipped, and the shadow pages
        already hold the prompts' draft KV)."""
        if self._drafter is None:
            return
        self._spec_state = self._drafter.begin(
            self._spec_state, slot_tokens, slot_tok0, prompts,
            None if tabs is None else torch.as_tensor(tabs,
                                                      device=self.device),
            s_max)

    def _run_spec_segment(self, tok0, tab, pos0, eos, done, remaining, seg,
                          stop_on_finish=False):
        """Speculative decode from ``tok0`` (already emitted) at per-slot
        positions ``pos0``, all operands device tensors.

        Each step: the drafter proposes ``k`` tokens, the target verifies
        ``tok + drafts`` in one ``verify_paged`` call (all ``k + 1`` KV rows
        written; rejected rows are rewritten by the next step at the same
        positions and masked by ``kv_len`` until then), and the greedy rule
        emits ``m`` tokens a live slot into ``buf`` at its own count.
        Finished slots freeze; ``stop_on_finish`` ends the segment after
        the first verify in which a slot newly finishes.  Returns
        ``(buf (B, seg + 1), counts (B,),
        steps, done (B,), proposed, accepted)``, the counters on the device;
        row ``b`` holds ``counts[b]`` tokens (column ``seg`` takes the
        rejected rows' writes).
        """
        drafter, k = self._drafter, self._drafter.k
        B = tok0.shape[0]
        dev = self.device
        j = torch.arange(k + 1, device=dev)[None, :]
        done = done | ((eos >= 0) & (tok0[:, 0] == eos)) | (remaining <= 0)
        fin0 = done
        buf = torch.zeros((B, seg + 1), dtype=torch.long, device=dev)
        cnt = torch.zeros(B, dtype=torch.long, device=dev)
        prop = torch.zeros((), dtype=torch.long, device=dev)
        acc = torch.zeros((), dtype=torch.long, device=dev)
        tok, pos, state, it = tok0, pos0, self._spec_state, 0
        halt = seg <= 0 or bool(done.all())
        while not halt:
            live = ~done
            drafts, state = drafter.propose(state, tok, pos, tab)
            logits, _ = self.model.verify_paged(
                self.params, torch.cat([tok, drafts], dim=1), self.pool.kv,
                tab, pos, page_size=self.page_size,
                cache_dtype=self.cache_dtype)
            blk = torch.argmax(logits, dim=-1)                  # (B, k + 1)
            m, n_acc = accept_blocks(drafts, blk, eos=eos,
                                     budget=remaining - cnt, live=live)
            emit = j < m[:, None]
            buf.scatter_(1, torch.where(emit, cnt[:, None] + j, seg), blk)
            cnt = cnt + m
            pos = pos + m
            last = blk.gather(1, (m - 1).clamp(min=0)[:, None])
            tok = torch.where(live[:, None], last, tok)
            hit_eos = (emit & (eos[:, None] >= 0)
                       & (blk == eos[:, None])).any(dim=1)
            done = done | (live & (hit_eos | (cnt >= remaining)))
            state = drafter.observe(state, blk, m, pos - m, tab)
            prop = prop + k * live.sum()
            acc = acc + torch.where(live, torch.minimum(
                n_acc, (m - 1).clamp(min=0)), 0).sum()
            it += 1
            # the one host read of a verify step: the halt test
            if stop_on_finish:
                flags = torch.stack([done.all(), (done & ~fin0).any()])
                halt = it >= seg or bool(flags.any())
            else:
                halt = it >= seg or bool(done.all())
        self._spec_state = state
        return buf, cnt, it, done, prop, acc

    def _dispatch_spec_segment(self, tok0, pos0, eos_vec, done0, remaining,
                               tabs, seg, stop_on_finish=False):
        """One speculative segment under the scrub: host arrays in, as
        :meth:`_dispatch_segment`.  Returns ``(tokens (B, n) host, steps,
        done (B,), counts (B,), SpecStats)``; row ``b`` holds its
        ``counts[b]`` tokens and zeros after them, ``n`` the largest
        count."""
        dev = self.device
        as_dev = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
        pending = self._scrub_launch()
        buf, cnt, steps, done, prop, acc = self._run_spec_segment(
            tok0, as_dev(tabs, np.int32), as_dev(pos0, np.int64),
            as_dev(np.clip(eos_vec, -1, 2**31 - 1), np.int64),
            as_dev(done0, bool), as_dev(remaining, np.int64), seg,
            stop_on_finish)
        self._last_scrub = self._drain_scrub(pending)
        self._last_recompute = np.zeros(tok0.shape[0], bool)
        counts = cnt.cpu().numpy()
        n = int(counts.max()) if counts.size else 0
        prop, acc = int(prop), int(acc)
        st = SpecStats(proposed=prop, accepted=acc, emitted=int(counts.sum()),
                       verify_steps=steps, blocks=prop // self._drafter.k)
        sp = self.stats.spec
        sp.proposed += st.proposed
        sp.accepted += st.accepted
        sp.emitted += st.emitted
        sp.verify_steps += st.verify_steps
        sp.blocks += st.blocks
        self.stats.decode_steps += steps
        self.stats.decode_dispatches += steps
        return buf[:, :n].cpu().numpy(), steps, done.cpu().numpy(), counts, st

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

    def _sync_fallback_gathers(self) -> None:
        """``stats.fallback_gathers`` from the runners' counter: nonzero
        means this engine's mesh and moduli set do not fit the channel
        split, and its matmuls gather the channels instead."""
        self.stats.fallback_gathers = (runners.fallback_gather_count()
                                       - self._fallback_base)

    # -- the dense-cache loop ------------------------------------------------

    def _generate_dense(self, tok, cache, plen, max_new, eos_vec, done0,
                        temperature, generator, prefill_logits, t0, t1
                        ) -> GenerateResult:
        """Decode over the prefill's dense cache (module docstring): token
        ``i`` is emitted, the done mask updated, and unless every slot is
        done or this was the last token one step at ``plen + i`` samples
        token ``i + 1``."""
        f_det, f_cor = self._drain_scrub(self._scrub_launch())
        watch = bool((eos_vec >= 0).any())
        eos = torch.as_tensor(np.clip(eos_vec, -1, 2**31 - 1),
                              device=self.device)
        done = np.asarray(done0, bool)
        outs, steps = [], 0
        for i in range(max_new):
            outs.append(tok)
            if watch:
                done = done | self._eos_hit(tok, eos)
            if done.all():
                break       # every live slot has hit its EOS
            if i + 1 == max_new:
                break       # last token emitted; no step needed for it
            logits, cache = self.model.decode(self.params, tok, cache,
                                              plen + i)
            steps += 1
            tok = self._sample(logits, temperature, generator)
        tokens_np = torch.cat(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        self.stats.decode_steps += steps
        self.stats.decode_dispatches += steps
        self._sync_fallback_gathers()
        return GenerateResult(
            tokens=tokens_np, prefill_logits=prefill_logits, steps=steps,
            stats=RequestStats(decode_steps=steps, decode_dispatches=steps,
                               prefill_s=t1 - t0, decode_s=t2 - t1,
                               faults_detected=f_det,
                               faults_corrected=f_cor))

    # -- generate ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, batch_inputs: dict[str, Any], *, max_new: int,
                 prompt_len: int | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 eos: int | np.ndarray | None = None,
                 active: np.ndarray | None = None) -> GenerateResult:
        """Prefill ``batch_inputs["tokens"]`` (B, S), then decode up to
        ``max_new`` tokens per slot (the first comes from the prefill).

        The vlm family also takes ``batch_inputs["patches"]`` (B, n_img, d),
        put before the tokens (the prompt is ``n_img + S`` positions); the
        audio family takes ``batch_inputs["frames"]`` (B, S_enc, d) for its
        encoder, ``tokens`` being the decoder prompt (served from the dense
        cache: the decoder's ``dec_len`` bounds prompt and budget, and
        ``s_max`` is the encoder memory's length).

        ``prompt_len``: position of the first generated token (the prompt
        length by default).  ``eos``: a scalar or per-slot ``(B,)`` stop
        token (negative entries never match); decoding halts once every
        slot is done, and slots marked False in ``active`` count as done
        from the start.  Without ``eos`` every slot runs ``max_new``.
        """
        cfg = self.model.cfg
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]),
                                 device=self.device).long()
        B, S = tokens.shape
        patches = batch_inputs.get("patches")
        frames = batch_inputs.get("frames")
        if cfg.is_encdec and frames is None:
            raise ValueError(f"{cfg.name} needs batch_inputs['frames']")
        n_img = 0 if patches is None else int(patches.shape[1])
        plen = S + n_img if prompt_len is None else int(prompt_len)
        if B > self.batch:
            raise ValueError(f"{B} prompts for an engine of batch "
                             f"{self.batch}")
        limit, what = ((cfg.dec_len, "the decoder's dec_len") if
                       cfg.is_encdec else (self.s_max, "s_max"))
        if plen + max_new > limit:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"{what} {limit}")
        if eos is not None:
            eos_vec = np.broadcast_to(np.asarray(eos, np.int64), (B,))
            done0 = (np.zeros(B, bool) if active is None
                     else ~np.asarray(active, bool))
        else:
            eos_vec = np.full(B, -1, np.int64)
            done0 = np.zeros(B, bool)
        greedy = temperature <= 0.0 or generator is None
        if self._drafter is not None and not greedy:
            raise ValueError("speculative decoding (spec=) is greedy "
                             "acceptance only; run with temperature=0")
        if self._drafter is not None and patches is not None:
            raise ValueError("spec= needs token prompts (the drafters "
                             "condition on the token stream)")
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(
            self.params, tokens, s_max=self.s_max,
            cache_dtype=self.cache_dtype, patches=patches, frames=frames)
        prefill_logits = logits.to(torch.float32).cpu().numpy()
        t1 = time.perf_counter()
        tok = self._sample(logits, temperature, generator)
        if not self.paged:
            return self._generate_dense(tok, cache, plen, max_new, eos_vec,
                                        done0, temperature, generator,
                                        prefill_logits, t0, t1)
        k_dense, v_dense = cache

        pool = self.pool
        pool.reset()    # generate() owns the whole pool for this call
        a0 = pool.stats.snapshot()
        # a verify writes up to k rows past the last emitted one: the
        # headroom keeps them on the slot's own pages (rows past the table
        # go to the dump page)
        k_spec = self._drafter.k if self._drafter is not None else 0
        n_pages = min(-(-(plen + max_new + k_spec) // self.page_size),
                      self.n_pmax)

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
        if self._drafter is not None:
            p_np, t_np = tokens.cpu().numpy(), tok[:, 0].cpu().numpy()
            self._spec_state = self._drafter.init_state(B)
            self._spec_begin({b: p_np[b] for b in range(B)},
                             {b: int(t_np[b]) for b in range(B)}, tokens,
                             tabs, S)
        g_state = None if generator is None else generator.get_state()
        recomputes = 0
        spec_stats = None
        while True:
            if self._drafter is not None:
                buf, steps, _, _, spec_stats = self._dispatch_spec_segment(
                    tok, np.full(B, plen), eos_vec, done0,
                    np.full(B, max_new - 1), tabs, max_new - 1)
            else:
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
        self._sync_fallback_gathers()
        return GenerateResult(
            tokens=tokens_np, prefill_logits=prefill_logits, steps=steps,
            stats=RequestStats(
                decode_steps=steps, decode_dispatches=steps,
                pages_allocated=pool.stats.pages_allocated
                - a0.pages_allocated,
                pages_freed=pool.stats.pages_freed - a0.pages_freed,
                prefill_s=t1 - t0, decode_s=t2 - t1,
                faults_detected=f_det, faults_corrected=f_cor,
                recomputes=recomputes, spec=spec_stats))

    # -- continuous batching: admission and segments --------------------------

    @property
    def spec_lookahead(self) -> int:
        """Draft block size k (0 without spec=): the KV headroom an
        admission reserves for a verify's overshoot."""
        return self._drafter.k if self._drafter is not None else 0

    @torch.no_grad()
    def admit_prefill(self, slot_tokens: dict[int, np.ndarray],
                      slot_total: dict[int, int]):
        """Admit requests into slots: pages from ``pool.admit`` (full
        prompt pages shared by token prefix), one right-padded prefill over
        the admitted prompts that need one, their KV scattered into their
        pages, and their logits remembered for later prefill skips.

        ``slot_tokens``: slot -> prompt tokens; ``slot_total``: slot ->
        bound on the request's final KV length (prompt and budget).  Returns
        ``{slot: (prefill logits (vocab,) f32, AdmitInfo)}``; a page-aligned
        prompt seen whole before takes its cached logits and no prefill.

        The prefill runs over the prompts that need it alone, padded to the
        longest of them (rows read their logits at their own last token;
        causal attention keeps each prompt's rows independent of the
        padding).  Pages shared from the prefix cache are not written
        again: their table entries point at the dump page for the scatter.
        """
        if not self.paged:
            raise ValueError("admit_prefill needs paged serving")
        with tracing.span("engine.admit_prefill"):
            return self._admit_prefill(slot_tokens, slot_total)

    def _admit_prefill(self, slot_tokens: dict[int, np.ndarray],
                       slot_total: dict[int, int]):
        pool, dev = self.pool, self.device
        with tracing.span("engine.pages"):
            infos = {s: pool.admit(np.asarray(slot_tokens[s]),
                                   slot_total[s])
                     for s in sorted(slot_tokens)}
            out = {s: (inf.cached_logits, inf) for s, inf in infos.items()
                   if inf.cached_logits is not None}
            need = [s for s, inf in infos.items()
                    if inf.cached_logits is None]
            prompts = tabs = None
            S = 0
            if need:
                lens = np.array([len(slot_tokens[s]) for s in need])
                S = int(lens.max())
                if S > self.n_pmax * self.page_size:
                    raise ValueError(f"prompt of {S} tokens exceeds the "
                                     f"{self.n_pmax * self.page_size} "
                                     f"positions of a slot")
                prompts_np = np.zeros((len(need), S), np.int64)
                tabs = np.zeros((len(need), self.n_pmax), np.int32)
                for i, s in enumerate(need):
                    prompts_np[i, : lens[i]] = slot_tokens[s]
                    row = pool.tab_row(infos[s].pages, self.n_pmax)
                    row[infos[s].shared] = 0
                    tabs[i] = row
        if need:
            tracing.count("engine.prefill_rows", len(need) * S)
            tracing.count("engine.prompt_tokens", int(lens.sum()))
            with tracing.span("engine.prefill"):
                prompts = torch.as_tensor(prompts_np, device=dev)
                logits, (k, v) = self.model.prefill(
                    self.params, prompts, s_max=S,
                    logits_at=torch.as_tensor(lens - 1, device=dev),
                    cache_dtype=self.cache_dtype, lengths=lens.tolist())
                logits = logits.to(torch.float32).cpu().numpy()
            self._scatter(k, v, torch.as_tensor(tabs, device=dev))
            del k, v
            for i, s in enumerate(need):
                pool.remember_logits(slot_tokens[s], logits[i])
                out[s] = (logits[i], infos[s])
        self._spec_begin(
            {s: np.asarray(slot_tokens[s]) for s in slot_tokens},
            {s: int(np.argmax(out[s][0])) for s in slot_tokens}, prompts,
            tabs, S)
        return out

    @torch.no_grad()
    def paged_segment(self, tok0, pos0, remaining, eos_vec, done0, tabs, *,
                      seg: int, stop_on_finish: bool) -> SegmentResult:
        """One greedy decode segment of the continuous scheduler.

        ``tok0 (B, 1)``: each slot's last emitted token; ``pos0 (B,)``: the
        position its KV row lands at; ``remaining (B,)``: the slot's budget
        after ``tok0``; ``done0 (B,)``: slots that take no part;
        ``tabs (B, n_pmax)``: the block tables.  ``stop_on_finish`` ends
        the segment after the first step in which a slot newly finishes.
        """
        if not self.paged:
            raise ValueError("paged_segment needs paged serving")
        tok = torch.as_tensor(np.asarray(tok0), device=self.device
                              ).long().reshape(-1, 1)
        B = tok.shape[0]
        remaining = np.asarray(remaining, np.int64)
        prop = acc = 0
        if self._drafter is not None:
            buf, steps, done, counts, st = self._dispatch_spec_segment(
                tok, pos0, eos_vec, done0, remaining, tabs, seg,
                stop_on_finish)
            prop, acc = st.proposed, st.accepted
        else:
            buf, steps, done = self._dispatch_segment(
                tok, np.asarray(pos0, np.int32), eos_vec, done0, remaining,
                tabs, seg, 0.0, None, stop_on_finish)
            counts = np.full(B, steps, np.int64)
        f_det, f_cor = self._last_scrub
        self._sync_fallback_gathers()
        return SegmentResult(tokens=buf, steps=steps, done=done,
                             faults_detected=f_det, faults_corrected=f_cor,
                             counts=counts, proposed=prop, accepted=acc,
                             needs_recompute=self._last_recompute.copy())
