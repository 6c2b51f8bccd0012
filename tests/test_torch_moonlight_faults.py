"""Each fault the ``serve_mla`` driver's check is there to catch, planted
beneath the timed path of a tiny CPU run of ``moonlight-16b-a3b.prefill``
(``test_torch_moonlight._tiny_cell``: the cell's files, driver and limits,
the widths and mix made tiny, capacity factor 1.25), turns ``correct``
false at the cell's own limits:

* the latent pages left as they were, or written for half the batch;
* B2 run on half the batch (the other half's rows zero);
* padded rows counted in the experts' capacity and placement (the
  behaviour of an expert layer called without ``valid`` / ``n_tokens``);
* the correction bias ignored in the choice of experts;
* the shared experts left out of the expert layer's output.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.models import moe
from repro_torch.numerics import kv_pages

from test_torch_moonlight import _tiny_cell, bench
from torch_threads import one_thread  # noqa: F401


def _stale_pages(mp):
    """The scatter returns the pages as they were."""
    def fault(engine):
        mp.setattr(kv_pages, "scatter_prefill",
                   lambda paged, *a, **k: paged)
    return fault


def _half_pages(mp):
    """The scatter writes zeros for the second half of the batch (the
    dense latent and rotary key are ``(L, B, S, 1, width)``)."""
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


def _expert_layer(mp, change):
    """``moe.moe`` with its arguments changed by ``change(params, kw)``."""
    layer = moe.moe

    def call(params, x, **kw):
        p, k = change(params, dict(kw))
        return layer(p, x, **k)

    def fault(engine):
        mp.setattr(moe, "moe", call)
    return fault


def _pad_in_capacity(mp):
    """Padded rows take expert slots: no ``valid`` / ``n_tokens``, so the
    capacity counts every row of B x S and the pad rows' slots are placed
    ahead of the next prompt's real tokens."""
    def change(params, kw):
        kw.pop("valid", None)
        kw.pop("n_tokens", None)
        return params, kw
    return _expert_layer(mp, change)


def _no_shared(mp):
    """The shared experts are left out."""
    def change(params, kw):
        return {k: v for k, v in params.items() if k != "shared"}, kw
    return _expert_layer(mp, change)


def _bias_ignored(mp):
    """The experts are chosen on the scores alone (a zero bias)."""
    route = moe.route_sigmoid

    def bad(router_w, bias, *a, **k):
        return route(router_w, torch.zeros_like(bias), *a, **k)

    def fault(engine):
        mp.setattr(moe, "route_sigmoid", bad)
    return fault


# each fault and the stage's number that must pass its limit
FAULTS = {
    "pages unchanged": (_stale_pages, "kv_err"),
    "half the pages": (_half_pages, "kv_err"),
    "half the attention": (_half_attention, "attn_err"),
    "pad rows in the capacity": (_pad_in_capacity, "route_diff"),
    "bias ignored": (_bias_ignored, "route_diff"),
    "shared experts dropped": (_no_shared, "mlp_err"),
}
SEEDS = [11, 2**34 + 7]


def _run(seed, fault=None):
    cell = _tiny_cell()
    run = bench.driver(cell).run(cell, seed=seed, seconds=0.3, trace=False,
                                 device="cpu", t_start=0.0, fault=fault)
    return cell, run


@pytest.mark.parametrize("seed", SEEDS)
def test_unfaulted_run_is_correct(seed):
    """The same runs with nothing planted pass (so a fault below is what
    turns them)."""
    _, run = _run(seed)
    assert run.correct, run.numbers


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS),
                         ids=lambda v: v.replace(" ", "-"))
def test_fault_fails_the_mla_check(fault, seed, monkeypatch):
    make, number = FAULTS[fault]
    cell, run = _run(seed, make(monkeypatch))
    # the run was checked, and the fault's stage passed its limit
    assert all(math.isfinite(v) for v in run.numbers.values()), run.numbers
    assert run.numbers[number] > cell.workload["limits"][number], run.numbers
    assert not run.correct, run.numbers
