"""Block-table page pool: the host-side allocator of the paged KV cache.

Port of ``repro/serving/kv_pool.py``.  The device side (page pools,
residue planes, scatter and append) lives in
:mod:`repro_torch.numerics.kv_pages`; this module keeps what the host
tracks about the pages:

* a **free list** over pages ``1..P-1``.  Page 0 is the reserved *dump*
  page: every block-table entry defaults to it, so writes from inactive
  slots, finished slots running past their budget and the padded tail of a
  prompt land where no live slot attends (``kv_len`` masks it).
* a **refcount** per page, since several requests may hold one prompt page.
* the **prefix cache**: ``tokens[:j*ps] -> page`` for every *full* page of
  an admitted prompt.  A K/V row is a function of its token and position
  and the page quantization is deterministic, so a page's bytes are a
  function of the token prefix: requests with the same first ``j*ps``
  tokens share the page.  When a *whole* page-aligned prompt was seen
  before, its cached prefill logits let admission skip the prefill.
* pages whose refcount drops to 0 but that back a prefix entry stay
  *cached-free*: off the free list, revived by a hit, and evicted oldest
  entry first when the free list runs dry.

Quarantine models a sticky hardware fault: a quarantined page leaves the
free list and the prefix cache for good, and stays out across
:meth:`KVPagePool.reset`.

Per page: free -> active (ref > 0) -> [cached-free -> active]* -> free
(the release of an uncached page, or the eviction of a cached one).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.numerics import kv_pages as kvp
from repro_torch.serving.stats import PoolStats

__all__ = ["KVPagePool", "AdmitInfo"]

_LOGITS_CACHE_CAP = 512


@dataclasses.dataclass
class AdmitInfo:
    pages: list[int]              # the page list (prompt, then decode region)
    prefix_hits: int              # prompt pages reused from the prefix cache
    pages_allocated: int          # pages newly allocated
    cached_logits: np.ndarray | None  # set iff the prefill can be skipped
    # indices in ``pages`` of the prompt pages taken from the prefix cache
    # (their bytes are in place: admission does not write them again)
    shared: list[int] = dataclasses.field(default_factory=list)


class KVPagePool:
    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv: int, head_dim: int, *, fmt: str = "bf16",
                 dtype=torch.bfloat16, device="cuda",
                 prefix_cache: bool = True, v_head_dim: int | None = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the dump page)")
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_kv = n_kv
        self.head_dim = head_dim
        self.v_head_dim = v_head_dim or head_dim
        self.fmt = kvp.KV_FORMATS[fmt] if isinstance(fmt, str) else fmt
        self.dtype = dtype
        self.prefix_enabled = prefix_cache
        self.kv = kvp.make_paged_kv(n_layers, num_pages, page_size, n_kv,
                                    head_dim, fmt=self.fmt, dtype=dtype,
                                    device=device,
                                    v_head_dim=self.v_head_dim)
        self.stats = PoolStats()
        self._quarantined: set[int] = set()
        self._fault_counts: dict[int, int] = {}
        self.reset()

    def reset(self) -> None:
        """Drop all allocator state (device bytes just go stale);
        quarantined pages stay out."""
        self._free = [p for p in range(self.num_pages - 1, 0, -1)
                      if p not in self._quarantined]
        self._ref = np.zeros(self.num_pages, np.int64)
        self._prefix: dict[tuple, int] = {}         # token prefix -> page
        self._page_key: dict[int, tuple] = {}       # page -> its prefix key
        self._logits: dict[tuple, np.ndarray] = {}  # whole prompt -> logits

    # -- allocation ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages on the free list (cached-free pages come on top)."""
        return len(self._free)

    def _alloc_one(self) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            pid = next((p for p in self._page_key if self._ref[p] == 0),
                       None)
            if pid is None:
                extra = (f" ({len(self._quarantined)} pages quarantined)"
                         if self._quarantined else "")
                raise RuntimeError(f"KV page pool exhausted{extra}")
            self._evict(pid)
        self._ref[pid] = 1
        self.stats.pages_allocated += 1
        return pid

    def _evict(self, pid: int) -> None:
        key = self._page_key.pop(pid)
        self._prefix.pop(key, None)
        self.stats.evictions += 1

    def alloc(self, n: int) -> list[int]:
        """``n`` exclusive pages (no prefix sharing): the generate() path."""
        return [self._alloc_one() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        """Drop one reference a page: an uncached page goes back on the free
        list, a prefix-cached one becomes cached-free (page 0 is never
        freed, a quarantined page never comes back, and a page no one holds
        is left as it is)."""
        for pid in pages:
            if pid == 0 or self._ref[pid] == 0:
                continue
            self._ref[pid] -= 1
            if self._ref[pid] > 0:
                continue
            self.stats.pages_freed += 1
            if pid not in self._page_key and pid not in self._quarantined:
                self._free.append(pid)

    # -- fault escalation ----------------------------------------------------

    @property
    def quarantined_pages(self) -> frozenset[int]:
        return frozenset(self._quarantined)

    def note_fault(self, pid: int) -> int:
        """Record one detected fault on a page; returns its running count
        (the engine quarantines a page that keeps re-faulting)."""
        n = self._fault_counts.get(pid, 0) + 1
        self._fault_counts[pid] = n
        return n

    def quarantine(self, pid: int) -> bool:
        """Retire a page for good: off the free list and out of the prefix
        cache now, and never back on the free list once released (a live
        holder keeps its reference; the engine recomputes it).  Returns True
        if it was newly quarantined (the dump page is immune)."""
        if pid == 0 or pid in self._quarantined:
            return False
        self._quarantined.add(pid)
        if pid in self._free:
            self._free.remove(pid)
        if pid in self._page_key:
            self._evict(pid)
        return True

    # -- admission -----------------------------------------------------------

    def admit(self, tokens: np.ndarray, total_positions: int) -> AdmitInfo:
        """The page list of a request: shared full prompt pages, then
        exclusive pages (the partial prompt page and the decode region).

        ``total_positions`` bounds the request's final KV length (prompt and
        budget); the list covers ``ceil(total / ps)`` pages.
        """
        ps = self.page_size
        tokens = np.asarray(tokens, np.int64)
        plen = len(tokens)
        n_need = -(-max(total_positions, plen) // ps)
        n_full = plen // ps
        pages: list[int] = []
        shared: list[int] = []
        hits = fresh = 0
        for j in range(n_full):
            key = tuple(tokens[: (j + 1) * ps].tolist())
            pid = self._prefix.get(key) if self.prefix_enabled else None
            if pid is not None:
                if self._ref[pid] == 0:
                    # a cached-free page comes back into service
                    self.stats.pages_allocated += 1
                self._ref[pid] += 1
                hits += 1
                shared.append(j)
            else:
                pid = self._alloc_one()
                fresh += 1
                if self.prefix_enabled:
                    if pid in self._page_key:
                        self._evict(pid)
                    self._prefix[key] = pid
                    self._page_key[pid] = key
            pages.append(pid)
        for _ in range(n_need - n_full):
            pages.append(self._alloc_one())
            fresh += 1
        self.stats.prefix_hits += hits

        cached = None
        if (self.prefix_enabled and plen and plen % ps == 0
                and hits == n_full):
            cached = self._logits.get(tuple(tokens.tolist()))
            if cached is not None:
                self.stats.prefill_skips += 1
        return AdmitInfo(pages=pages, prefix_hits=hits,
                         pages_allocated=fresh, cached_logits=cached,
                         shared=shared)

    def remember_logits(self, tokens: np.ndarray, logits: np.ndarray) -> None:
        """Cache a prompt's prefill logits for later prefill skips (the
        oldest of ``_LOGITS_CACHE_CAP`` prompts goes first)."""
        if not self.prefix_enabled:
            return
        if len(self._logits) >= _LOGITS_CACHE_CAP:
            self._logits.pop(next(iter(self._logits)))
        self._logits[tuple(np.asarray(tokens, np.int64).tolist())] = \
            np.asarray(logits)

    # -- accounting ----------------------------------------------------------

    def tab_row(self, pages: list[int], n_pmax: int) -> np.ndarray:
        """(n_pmax,) block-table row: the page list, dump-padded."""
        row = np.zeros(n_pmax, np.int32)
        row[: len(pages)] = pages
        return row

    def bytes_per_resident_token(self) -> int:
        """KV bytes one resident token takes across all layers."""
        return self.n_layers * kvp.bytes_per_token(
            self.fmt, self.n_kv, self.head_dim, self.dtype, self.v_head_dim)

    def pool_bytes(self) -> int:
        return kvp.pool_bytes(self.kv)

    def stats_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self.stats)
