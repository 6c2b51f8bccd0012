"""Port parity: the host page pool's prefix cache, refcounts and eviction.

The same sequence of ``alloc`` / ``admit`` / ``release`` / ``quarantine`` /
``remember_logits`` calls goes to the reference's ``KVPagePool`` and the
port's; after every call the page lists, ``AdmitInfo`` fields, free lists
and ``PoolStats`` must be equal.  The fixed cases mirror
``tests/test_paged_serving.py`` (refcounts, cached-free revival, eviction,
the prefill skip on page-aligned whole-prompt hits only) and
``tests/test_fault_policy.py`` (quarantine); the random sequences drive
both pools through the same ops drawn from a numpy seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.serving.kv_pool import KVPagePool as JPool
from repro_torch.serving.kv_pool import KVPagePool


class Both:
    """One reference pool and one port pool driven in step."""

    def __init__(self, num_pages=8, page_size=4, prefix_cache=True):
        self.j = JPool(1, num_pages, page_size, 1, 8, fmt="bf16",
                       prefix_cache=prefix_cache)
        self.t = KVPagePool(1, num_pages, page_size, 1, 8, fmt="bf16",
                            device="cpu", prefix_cache=prefix_cache)

    def check(self):
        j, t = self.j, self.t
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
        assert t._free == j._free and t.free_pages == j.free_pages
        np.testing.assert_array_equal(t._ref, j._ref)
        assert t._page_key == j._page_key and t._prefix == j._prefix
        assert t.quarantined_pages == j.quarantined_pages

    def admit(self, toks, total):
        a, b = self.j.admit(toks, total), self.t.admit(toks, total)
        assert (b.pages, b.prefix_hits, b.pages_allocated) == \
            (a.pages, a.prefix_hits, a.pages_allocated)
        assert (b.cached_logits is None) == (a.cached_logits is None)
        if a.cached_logits is not None:
            np.testing.assert_array_equal(b.cached_logits, a.cached_logits)
        # the port's extra field: which prompt pages came from the cache
        assert len(b.shared) == b.prefix_hits
        self.check()
        return b

    def call(self, name, *args):
        outs = [getattr(p, name)(*args) for p in (self.j, self.t)]
        if name in ("alloc", "quarantine", "note_fault"):
            assert outs[1] == outs[0]
        self.check()
        return outs[1]


def test_alloc_release_cycle():
    p = Both()
    pages = p.call("alloc", 3)
    assert len(set(pages)) == 3 and 0 not in pages
    assert p.t.free_pages == 4
    p.call("release", pages)
    assert p.t.free_pages == 7
    assert p.t.stats.pages_allocated == 3 == p.t.stats.pages_freed


def test_exhaustion_raises_in_both():
    p = Both(num_pages=4, prefix_cache=False)
    p.call("alloc", 3)
    for pool in (p.j, p.t):
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(1)


def test_prefix_sharing_refcounts():
    p = Both(page_size=4)
    toks = np.arange(10)
    a = p.admit(toks, 10)          # 2 full pages and a partial one
    assert a.prefix_hits == 0 and a.pages_allocated == 3
    b = p.admit(toks, 10)          # the full pages shared
    assert b.prefix_hits == 2 and b.pages_allocated == 1
    assert b.pages[:2] == a.pages[:2] and b.pages[2] != a.pages[2]
    assert b.shared == [0, 1] and a.shared == []
    p.call("release", a.pages)
    assert p.t.stats.pages_freed == 1      # shared pages still held by b
    p.call("release", b.pages)
    assert p.t.stats.pages_freed == 4


def test_cached_free_revival_and_eviction():
    p = Both(num_pages=4, page_size=4)     # 3 usable pages
    toks = np.arange(4)
    a = p.admit(toks, 4)                   # one full, cached page
    p.call("release", a.pages)             # cached-free: off the free list
    assert p.t.free_pages == 2
    b = p.admit(toks, 4)                   # revived from the cache
    assert b.prefix_hits == 1 and b.pages == a.pages
    p.call("release", b.pages)
    pages = p.call("alloc", 3)             # the free list runs dry
    assert p.t.stats.evictions == 1
    p.call("release", pages)
    c = p.admit(toks, 4)
    assert c.prefix_hits == 0              # the entry is gone


def test_prefill_skip_only_on_page_aligned_whole_prompt_hits():
    p = Both(page_size=4)
    aligned, ragged = np.arange(8), np.arange(7)
    p.admit(aligned, 8)
    p.admit(ragged, 7)
    p.call("remember_logits", aligned, np.ones(16))
    p.call("remember_logits", ragged, np.ones(16))
    assert p.admit(aligned, 8).cached_logits is not None
    assert p.admit(ragged, 7).cached_logits is None   # partial last page
    assert p.t.stats.prefill_skips == 1
    # a hit on every page but no remembered logits: no skip
    assert p.admit(np.arange(100, 108), 8).cached_logits is None
    assert p.admit(np.arange(100, 108), 8).cached_logits is None
    assert p.t.stats.prefill_skips == 1


def test_prefix_cache_off_shares_nothing():
    p = Both(prefix_cache=False)
    toks = np.arange(8)
    p.admit(toks, 12)
    p.call("remember_logits", toks, np.ones(4))
    b = p.admit(toks, 12)
    assert b.prefix_hits == 0 and b.cached_logits is None
    assert p.t.stats.prefix_hits == p.t.stats.prefill_skips == 0


def test_quarantine_evicts_the_prefix_entry():
    """Mirrors ``tests/test_fault_policy.py::test_pool_quarantine_semantics``
    and adds a prefix-cached page: quarantine drops its entry, its holder
    keeps it until release, and it never comes back."""
    p = Both(num_pages=6, page_size=4)
    assert p.call("quarantine", 0) is False       # the dump page is immune
    toks = np.arange(4)
    a = p.admit(toks, 6)
    shared = a.pages[0]
    assert p.call("quarantine", shared) is True
    assert p.call("quarantine", shared) is False  # idempotent
    assert p.t.stats.evictions == 1
    assert p.admit(toks, 4).prefix_hits == 0      # no entry to hit
    p.call("release", a.pages)
    assert shared not in p.t._free
    p.call("reset")                               # sticky: survives reset
    assert shared not in p.t._free
    assert p.call("note_fault", 5) == 1 and p.call("note_fault", 5) == 2


@pytest.mark.parametrize("seed", range(6))
def test_random_call_sequences_match_reference(seed):
    """Random admits over a few shared prefixes, releases of live requests,
    remembered logits and quarantines: every call leaves both pools equal
    (``Both.check``)."""
    rng = np.random.default_rng(seed)
    ps = 4
    p = Both(num_pages=16, page_size=ps)
    stems = [rng.integers(0, 50, 3 * ps) for _ in range(3)]
    live: list[list[int]] = []
    for _ in range(60):
        op = rng.random()
        if op < 0.5:
            stem = stems[rng.integers(len(stems))]
            if rng.random() < 0.5:        # a page-aligned repeat
                toks = stem[: ps * int(rng.integers(1, 4))]
            else:
                toks = np.concatenate([
                    stem[: int(rng.integers(1, 3 * ps + 1))],
                    rng.integers(0, 50, int(rng.integers(0, 3)))])
            total = len(toks) + int(rng.integers(0, 2 * ps))
            spare = p.t.free_pages + sum(
                1 for q in p.t._page_key if p.t._ref[q] == 0)
            if -(-total // ps) > spare:
                continue                  # it could exhaust the pool
            live.append(p.admit(toks, total).pages)
            if rng.random() < 0.5:
                p.call("remember_logits", toks,
                       rng.standard_normal(5).astype(np.float32))
        elif op < 0.85 and live:
            p.call("release", live.pop(int(rng.integers(len(live)))))
        elif op < 0.9:
            p.call("quarantine", int(rng.integers(1, 16)))
        else:
            p.call("note_fault", int(rng.integers(1, 16)))
    for pages in live:
        p.call("release", pages)
    assert not p.t._ref.any()
