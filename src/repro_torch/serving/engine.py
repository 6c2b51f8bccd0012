"""Batched serving engine over the paged KV pool.

Port of the paged path of ``repro/serving/engine.py``: ``generate``
prefills right-padded prompts in one pass, scatters the prefill KV into the
page pool (``_scatter``), then runs the decode steps and returns a
:class:`GenerateResult`.  The reference runs the decode loop as one
``lax.while_loop`` dispatch; here it is a plain Python loop of decode steps
(a CUDA graph is later work).  Under ``system="rns"`` the weights are made
residue-resident at construction (``model.prepare_params``).

Greedy decoding takes the ``argmax``; temperature sampling draws from a
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.api import Model, resolve_device
from repro_torch.numerics import kv_pages as kvp
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.serving.stats import EngineStats, RequestStats

__all__ = ["ServingEngine", "GenerateResult"]


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
                 device: torch.device | str = "cuda"):
        """``kv_format``: ``"bf16"``, ``"rns8"`` or ``"rns4"`` page storage.
        ``num_pages`` defaults to full capacity for ``batch`` slots plus the
        dump page.  ``device`` must be the model's device."""
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

    @torch.no_grad()
    def generate(self, batch_inputs: dict[str, Any], *, max_new: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> GenerateResult:
        """Prefill ``batch_inputs["tokens"]`` (B, S), then decode until each
        slot holds ``max_new`` tokens (the first comes from the prefill)."""
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]),
                                 device=self.device).long()
        B, plen = tokens.shape
        if B > self.batch:
            raise ValueError(f"{B} prompts for an engine of batch "
                             f"{self.batch}")
        if plen + max_new > self.s_max:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"s_max {self.s_max}")
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
        slot_pages = [pool.alloc(n_pages) for _ in range(B)]
        tab = torch.as_tensor(
            np.stack([pool.tab_row(p, self.n_pmax) for p in slot_pages]),
            device=self.device)
        self._scatter(k_dense, v_dense, tab)
        del k_dense, v_dense

        outs = [tok]
        for i in range(max_new - 1):
            pos = torch.full((B,), plen + i, dtype=torch.int32,
                             device=self.device)
            logits, _ = self.model.decode_paged(
                self.params, tok, pool.kv, tab, pos,
                page_size=self.page_size, cache_dtype=self.cache_dtype)
            tok = self._sample(logits, temperature, generator)
            outs.append(tok)
        steps = max_new - 1
        tokens_np = torch.cat(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        for p in slot_pages:
            pool.release(p)
        self.stats.decode_steps += steps
        self.stats.decode_dispatches += steps
        return GenerateResult(
            tokens=tokens_np,
            prefill_logits=prefill_logits, steps=steps,
            stats=RequestStats(
                decode_steps=steps, decode_dispatches=steps,
                pages_allocated=pool.stats.pages_allocated
                - a0.pages_allocated,
                pages_freed=pool.stats.pages_freed - a0.pages_freed,
                prefill_s=t1 - t0, decode_s=t2 - t1))
