"""Block-table page pool: the host-side allocator of the paged KV cache.

Page 0 is the reserved *dump* page: every block-table entry defaults to it,
so writes from the padded tail of a prompt land somewhere no live slot
attends to (``kv_len`` masks it).  Pages ``1..P-1`` sit on a free list.
Prefix sharing (refcounted shared prompt pages) waits for the scheduler
slice; every page here has one holder.
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
        self.reset()

    def reset(self) -> None:
        """Drop all allocator state (device bytes just go stale)."""
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int64)

    def alloc(self, n: int) -> list[int]:
        """``n`` exclusive pages."""
        if n > len(self._free):
            raise RuntimeError(f"KV page pool exhausted: {n} pages asked, "
                               f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self._ref[pages] = 1
        self.stats.pages_allocated += n
        return pages

    def release(self, pages: list[int]) -> None:
        """Return pages to the free list (page 0 is never freed)."""
        for pid in pages:
            if pid == 0 or self._ref[pid] == 0:
                continue
            self._ref[pid] = 0
            self._free.append(pid)
            self.stats.pages_freed += 1

    def tab_row(self, pages: list[int], n_pmax: int) -> np.ndarray:
        """(n_pmax,) block-table row: the page list, dump-padded."""
        row = np.zeros(n_pmax, np.int32)
        row[: len(pages)] = pages
        return row

    def pool_bytes(self) -> int:
        return kvp.pool_bytes(self.kv)
