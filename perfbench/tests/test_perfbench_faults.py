"""Each fault a cell can have, planted beneath the timed path of a tiny CPU
run, turns ``correct`` false at the cell's own limits: an answer altered
where it is produced, half of the batch left out, a step that leaves its
state unchanged."""
from __future__ import annotations

import dataclasses
import math

import pytest
import tiny
import torch


def _alter_prefill(mp):
    def fault(engine):
        prefill = engine.model.prefill

        def bad(*a, **k):
            logits, cache = prefill(*a, **k)
            return logits.roll(1, dims=-1), cache
        engine.model = dataclasses.replace(engine.model, prefill=bad)
    return fault


def _half_logits(mp):
    """The logits of the batch's first half stand in for the rest."""
    def fault(engine):
        prefill = engine.model.prefill

        def bad(params, tokens, *a, **k):
            logits, cache = prefill(params, tokens, *a, **k)
            h = max(1, logits.shape[0] // 2)
            return torch.cat([logits[:h]] * 2)[: logits.shape[0]], cache
        engine.model = dataclasses.replace(engine.model, prefill=bad)
    return fault


def _half_attention(mp):
    """B2 leaves the second half of the batch out (its rows stay zero)."""
    from repro_torch.numerics import attention  # noqa: F401 (registers B2)
    from repro_torch.numerics import registry
    fn = registry._REGISTRY["flash_attention"]["ref"]

    def bad(q, *a, **k):
        out = fn(q, *a, **k).clone()
        out[max(1, q.shape[0] // 2):] = 0
        return out

    def fault(engine):
        mp.setitem(registry._REGISTRY["flash_attention"], "ref", bad)
    return fault


def _half_scatter(mp):
    """The scatter writes zeros for the second half of the batch."""
    from repro_torch.numerics import kv_pages
    scatter = kv_pages.scatter_prefill

    def bad(paged, k, v, *a, **kw):
        h = max(1, k.shape[1] // 2)
        k, v = k.clone(), v.clone()
        k[:, h:] = 0
        v[:, h:] = 0
        return scatter(paged, k, v, *a, **kw)

    def fault(engine):
        mp.setattr(kv_pages, "scatter_prefill", bad)
    return fault


def _stale_pages(mp):
    """The scatter returns the pages as they were."""
    from repro_torch.numerics import kv_pages

    def fault(engine):
        mp.setattr(kv_pages, "scatter_prefill",
                   lambda paged, *a, **k: paged)
    return fault


def _alter_cnn(mp):
    def fault(forward):
        def bad(x):
            out = forward(x).clone()
            out[0, 0] += 1.0
            return out
        return bad
    return fault


def _half_cnn(mp):
    def fault(forward):
        def bad(x):
            h = x.shape[0] // 2
            out = forward(x[:h])
            return torch.cat([out, out])[: x.shape[0]]
        return bad
    return fault


FAULTS = {
    ("qwen3-8b.prefill", "altered answer"): _alter_prefill,
    ("qwen3-8b.prefill", "half the logits"): _half_logits,
    ("qwen3-8b.prefill", "half the attention"): _half_attention,
    ("qwen3-8b.prefill", "half the pages"): _half_scatter,
    ("qwen3-8b.prefill", "pages unchanged"): _stale_pages,
    ("vgg16-cifar.rns", "altered answer"): _alter_cnn,
    ("vgg16-cifar.rns", "half the batch"): _half_cnn,
    ("vgg16-cifar.sdrns", "altered answer"): _alter_cnn,
    ("vgg16-cifar.sdrns", "half the batch"): _half_cnn,
}
SEEDS = [11, 2**34 + 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,fault", sorted(FAULTS),
                         ids=lambda v: v.replace(" ", "-"))
def test_fault_fails_the_check(cell, fault, seed, monkeypatch):
    c = tiny.tiny_cell(cell)
    run = tiny.run(c, seed=seed, fault=FAULTS[(cell, fault)](monkeypatch))
    # the run was checked, and a number passed its limit
    assert all(math.isfinite(v) for v in run.numbers.values()), run.numbers
    assert any(v > c.workload["limits"][k]
               for k, v in run.numbers.items()), run.numbers
