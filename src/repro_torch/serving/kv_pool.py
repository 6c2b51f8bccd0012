"""Block-table page pool: the host-side allocator of the paged KV cache.

Page 0 is the reserved *dump* page: every block-table entry defaults to it,
so writes from the padded tail of a prompt land somewhere no live slot
attends to (``kv_len`` masks it).  Pages ``1..P-1`` sit on a free list.
Prefix sharing (refcounted shared prompt pages) waits for the scheduler
slice; every page here has one holder.

Quarantine models a sticky hardware fault: a quarantined page leaves the
free list for good and stays out across :meth:`KVPagePool.reset`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.numerics import kv_pages as kvp
from repro_torch.serving.stats import PoolStats

__all__ = ["KVPagePool"]


class KVPagePool:
    def __init__(self, n_layers: int, num_pages: int, page_size: int,
                 n_kv: int, head_dim: int, *, fmt: str = "bf16",
                 dtype=torch.bfloat16, device="cuda"):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the dump page)")
        self.n_layers = n_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.fmt = kvp.KV_FORMATS[fmt] if isinstance(fmt, str) else fmt
        self.kv = kvp.make_paged_kv(n_layers, num_pages, page_size, n_kv,
                                    head_dim, fmt=self.fmt, dtype=dtype,
                                    device=device)
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

    def _alloc_one(self) -> int:
        if not self._free:
            extra = (f" ({len(self._quarantined)} pages quarantined)"
                     if self._quarantined else "")
            raise RuntimeError(f"KV page pool exhausted{extra}")
        pid = self._free.pop()
        self._ref[pid] = 1
        self.stats.pages_allocated += 1
        return pid

    def alloc(self, n: int) -> list[int]:
        """``n`` exclusive pages."""
        return [self._alloc_one() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        """Return pages to the free list (page 0 is never freed, a
        quarantined page never comes back)."""
        for pid in pages:
            if pid == 0 or self._ref[pid] == 0:
                continue
            self._ref[pid] = 0
            self.stats.pages_freed += 1
            if pid not in self._quarantined:
                self._free.append(pid)

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
        """Retire a page for good: off the free list now, and never back on
        it once released.  Returns True if it was newly quarantined (the
        dump page is immune)."""
        if pid == 0 or pid in self._quarantined:
            return False
        self._quarantined.add(pid)
        if pid in self._free:
            self._free.remove(pid)
        return True

    def tab_row(self, pages: list[int], n_pmax: int) -> np.ndarray:
        """(n_pmax,) block-table row: the page list, dump-padded."""
        row = np.zeros(n_pmax, np.int32)
        row[: len(pages)] = pages
        return row

    def pool_bytes(self) -> int:
        return kvp.pool_bytes(self.kv)
