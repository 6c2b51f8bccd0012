"""Port parity: the continuous request scheduler and the fixed rounds.

The committed reduced qwen3-8b checkpoint is served by both packages'
``RequestScheduler`` with B 2, s_max 24 and 8-token pages; per-request
tokens must be equal.  The reference runs its residue matmuls through its
exact ``ref`` backend and its attention through its Pallas kernels in
interpret mode, on one engine a configuration (its jitted segments compile
once and serve every case; its pool is reset between cases).  The cases
mirror ``tests/test_paged_serving.py`` (mid-decode admission, prefix reuse
and prefill skip, EOS mid-page), ``tests/test_scheduler_and_props.py``
(fixed rounds), ``tests/test_spec_decode.py::test_spec_scheduler_parity``
and ``tests/test_fault_policy.py`` (strict recompute by re-admission and
sticky quarantine).  The speculative and the faulted runs are held against
the reference's plain and clean runs: the reference holds its own spec and
faulted tokens equal to those.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.moduli import P21R2 as JP21R2
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import RequestScheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.core.moduli import P21R2
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as tkv
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request, RequestScheduler
from repro_torch.testing.faults import FaultSpec, inject_faults

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")
B, S_MAX, PS = 2, 24, 8
# layer 0, page 1 (the first page the first admitted request holds), row 0,
# kv head 0, dim 0: a prompt KV row every decode step of that request reads
LIVE = (0, 1, 0, 0, 0)
RED, HALF = (17, 19), 120


@pytest.fixture(scope="module")
def tree():
    return load_npz(CKPT)


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen3-8b").reduced()


@contextlib.contextmanager
def _interpret():
    prev = set_attn_impl("interpret")
    try:
        yield
    finally:
        set_attn_impl(prev)


def _jengine(tree, *, rns_mset=None, **kw):
    jm = jbuild_model(jget_config("qwen3-8b").reduced(), system="rns",
                      rns_impl="ref", rns_mset=rns_mset)
    return JEngine(jm, jtu.tree_map(jnp.asarray, tree), batch=B,
                   s_max=S_MAX, page_size=PS, **kw)


def _tengine(tree, cfg, *, rns_mset=None, **kw):
    model = build_model(cfg, system="rns", rns_mset=rns_mset, device="cpu")
    kw.setdefault("page_size", PS)
    return ServingEngine(model, from_jax_params(tree, cfg, "cpu"), batch=B,
                         s_max=S_MAX, device="cpu", **kw)


@pytest.fixture(scope="module")
def jeng(tree):
    """The reference's paged engine on bf16 pages, for every case that
    runs on them."""
    return _jengine(tree, paged=True)


def _jserve(eng, specs, *, prefix_cache=True):
    """The reference scheduler on ``specs`` ``(tokens, max_new, eos)``,
    its pool reset first."""
    if eng.paged:
        eng.pool.reset()
        eng.pool.prefix_enabled = prefix_cache
    reqs = [JRequest(rid=i, tokens=t, max_new=m, eos=e)
            for i, (t, m, e) in enumerate(specs)]
    with _interpret():
        return JScheduler(eng).serve(reqs)


def _tserve(eng, specs):
    return RequestScheduler(eng).serve(
        [Request(rid=i, tokens=t, max_new=m, eos=e)
         for i, (t, m, e) in enumerate(specs)])


def _same(tout, jout):
    assert [r.rid for r in tout] == [r.rid for r in jout]
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.result, np.asarray(j.result),
                                      err_msg=f"rid {t.rid}")


def _all_free(eng):
    """Every page is free or cached-free, and no page has a holder."""
    pool = eng.pool
    assert not pool._ref.any()
    cached = set(pool._page_key)
    assert set(pool._free) | cached | pool.quarantined_pages == \
        set(range(1, pool.num_pages))


def _ragged(cfg):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, cfg.vocab, n).astype(np.int32), m, None)
            for n, m in zip((5, 9, 7, 4), (3, 10, 6, 8))]


@pytest.fixture(scope="module")
def ragged_ref(jeng, cfg):
    return _jserve(jeng, _ragged(cfg))


def test_mid_decode_admission_matches_reference(tree, cfg, ragged_ref):
    """More requests than slots, ragged prompts and budgets: a request is
    admitted while another slot is mid-decode, every result equals the
    reference's and a solo serve, and every page comes back."""
    eng = _tengine(tree, cfg)
    out = _tserve(eng, _ragged(cfg))
    _same(out, ragged_ref)
    for r in out:
        assert len(r.result) == r.max_new
        assert r.stats.pages_allocated > 0 and r.stats.pages_freed > 0
        assert r.stats.latency_s > 0
    # rid 0 (budget 3) finishes while rid 1 (budget 10) decodes: rid 2 is
    # admitted into the freed slot before rid 1 ends
    assert out[1].stats.decode_dispatches > 1
    _all_free(eng)
    for r, (t, m, _) in zip(out, _ragged(cfg)):
        solo = _tserve(eng, [(t, m, None)])[0]
        np.testing.assert_array_equal(r.result, solo.result)


def _prefix(cfg):
    """Three repeats of a page-aligned 16-token prompt (2 full pages), then
    two prompts that share its first page and go their own way."""
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 9)]
    return ([(toks, 4, None)] * 3
            + [(np.concatenate([toks[:8], t]), 5, None) for t in tails])


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_prefix_reuse_and_prefill_skip_match_reference(tree, cfg, jeng,
                                                       prefix_cache):
    """Shared prompt pages and skipped prefills: tokens, per-request hits
    and skips, and the pool's counters equal the reference's; without the
    prefix cache nothing is shared and the tokens are the same."""
    specs = _prefix(cfg)
    j0 = jeng.pool.stats.snapshot()
    jout = _jserve(jeng, specs, prefix_cache=prefix_cache)
    jd = {k: v - getattr(j0, k)
          for k, v in dataclasses.asdict(jeng.pool.stats).items()}
    eng = _tengine(tree, cfg, prefix_cache=prefix_cache)
    out = _tserve(eng, specs)
    _same(out, jout)
    assert dataclasses.asdict(eng.pool.stats) == jd
    assert [(r.stats.prefix_hits, r.stats.prefill_skipped) for r in out] == \
        [(r.stats.prefix_hits, r.stats.prefill_skipped) for r in jout]
    if prefix_cache:
        assert jd["prefix_hits"] >= 4 and jd["prefill_skips"] >= 1
        for r in out[1:3]:
            np.testing.assert_array_equal(r.result, out[0].result)
    else:
        assert jd["prefix_hits"] == jd["prefill_skips"] == 0
    _all_free(eng)


def test_eos_mid_page_matches_reference(tree, cfg, jeng):
    """An EOS landing mid-page retires its request at once; the other keeps
    decoding, and the freed pages return to the pool."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, 5).astype(np.int32)
    eng = _tengine(tree, cfg)
    probe = _tserve(eng, [(toks, 6, None)])[0]
    eos = int(probe.result[2])
    want = int(np.nonzero(probe.result == eos)[0][0]) + 1
    specs = [(toks, 12, eos), (toks, 12, None)]
    out = _tserve(eng, specs)
    _same(out, _jserve(jeng, specs))
    assert len(out[0].result) == want < 12 and out[0].result[-1] == eos
    assert len(out[1].result) == 12
    assert out[0].stats.pages_freed > 0
    _all_free(eng)


def test_fixed_rounds_on_dense_engine_match_reference(tree, cfg):
    """``paged=False``: rounds of ``batch`` requests, prompts right-aligned,
    per-slot EOS and the unfilled slot of the last round inactive."""
    rng = np.random.default_rng(3)
    toks = [rng.integers(1, cfg.vocab, n).astype(np.int32)
            for n in (8, 6, 8, 5, 7)]
    eng = _tengine(tree, cfg, paged=False)
    assert not eng.paged
    budgets = (6, 6, 4, 7, 5)
    probe = _tserve(eng, [(t, m, None) for t, m in zip(toks, budgets)])
    eos = int(probe[1].result[1])
    want = int(np.nonzero(probe[1].result == eos)[0][0]) + 1
    specs = [(t, m, eos if i == 1 else None)
             for i, (t, m) in enumerate(zip(toks, budgets))]
    out = _tserve(eng, specs)
    jout = _jserve(_jengine(tree, paged=False), specs)
    _same(out, jout)
    assert [len(r.result) for r in out] == [6, want, 4, 7, 5] and want <= 2
    assert [r.stats.decode_steps for r in out] == \
        [r.stats.decode_steps for r in jout]


@pytest.mark.parametrize("spec", ["ngram:2", "rns:2"])
def test_spec_scheduler_equals_plain(tree, cfg, ragged_ref, spec):
    """Continuous batching over a speculative engine: the reference's
    plain tokens, with per-request SpecStats filled."""
    eng = _tengine(tree, cfg, spec=spec)
    out = _tserve(eng, _ragged(cfg))
    _same(out, ragged_ref)
    for r in out:
        sp = r.stats.spec
        assert sp is not None and sp.verify_steps > 0
        assert 0 <= sp.accepted <= sp.proposed
    _all_free(eng)


def _sched_specs(cfg):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, cfg.vocab, 5).astype(np.int32), 8, None)
            for _ in range(2)]


@pytest.fixture(scope="module")
def strict_ref(tree, cfg):
    """The reference's clean tokens on P21R2 weights, rns8r pages and
    ``policy="strict"``."""
    eng = _jengine(tree, rns_mset=JP21R2, paged=True, kv_format="rns8r",
                   policy="strict")
    return _jserve(eng, _sched_specs(cfg))


def _tdouble(engine):
    """Both witnesses of one live K element rewritten to a value outside
    the range: detected and uncorrectable (the reference's
    ``_double_fault``)."""
    cf = engine.pool.kv.k.planes.movedim(-3, 0)
    fmt = tkv.KV_FORMATS["rns8r"]
    dec = int(fmt.pack.decode(cf[(0, *LIVE)].reshape(1, 1)
                              .to(torch.int32))[0, 0])
    v = next(v for v in range(HALF + 1, 240)
             if v % RED[0] != dec % RED[0] and v % RED[1] != dec % RED[1])
    cf[(1, *LIVE)] = v % RED[0]
    cf[(2, *LIVE)] = v % RED[1]
    return LIVE


@pytest.mark.parametrize("case", ["recompute", "sticky"])
def test_strict_faults_match_clean_reference(tree, cfg, strict_ref, case):
    """A page that fails repair (``recompute``: both witnesses of a live
    element overwritten) or keeps re-faulting (``sticky``, quarantined after
    2 strikes) mid-segment: the request holding it is re-admitted with its
    trusted prefix riding the prompt, and every request's tokens equal the
    clean run's (the reference's, and the port's own)."""
    kw = dict(rns_mset=P21R2, kv_format="rns8r", policy="strict")
    clean = _tserve(_tengine(tree, cfg, **kw), _sched_specs(cfg))
    _same(clean, strict_ref)
    if case == "recompute":
        eng = _tengine(tree, cfg, **kw)
        faults = [_tdouble]
    else:
        eng = _tengine(tree, cfg, quarantine_after=2, **kw)
        faults = [FaultSpec(kind="kv_sticky", which="k", channel=2, at=LIVE,
                            bit=0x01)]
    with inject_faults(eng, faults, after_steps=2) as log:
        out = _tserve(eng, _sched_specs(cfg))
    assert len(log) == 1
    _same(out, strict_ref)
    f = eng.stats.faults
    assert eng.pool.quarantined_pages == frozenset({LIVE[1]})
    assert f.pages_quarantined == 1
    if case == "recompute":
        assert f.recomputes == 1 and f.uncorrected >= 1
        assert [r.stats.recomputes for r in out] == [1, 0]
    else:
        assert f.syndromes >= 2 and f.replays >= 1
    _all_free(eng)
