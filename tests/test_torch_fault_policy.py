"""Port parity: the serving engine's fault layer, and ``generate``'s
``eos`` / ``active`` / ``prompt_len``.

Both packages serve the committed reduced qwen3-8b checkpoint (the prompts
of ``test_torch_serving.py``) with P21R2 weights and rns8r pages under a
fault ``policy``.  The same faults are injected into both engines mid-decode
(``testing/faults.py`` in each package); every ``FaultStats`` counter and
the quarantined pages must be equal between the packages, and the port's
tokens must equal its own clean run's.  The reference runs its residue
matmuls through its exact ``ref`` backend and its attention through its
Pallas kernels in interpret mode.

The port's clean tokens are held against the reference's model functions
driven step by step: the reference's jitted engine rounds its page scales
one ulp off its own ``quantize_to_format`` (``test_torch_serving.py``,
ROADMAP C), which can move a token at a rounding tie.
"""
from __future__ import annotations

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
from repro.numerics import kv_pages as jkv
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_pool import KVPagePool as JPool
from repro.testing import faults as jfaults
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.core.moduli import P21R2
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as tkv
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.testing import faults as tfaults

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")
B, PLEN, MAX_NEW, PS = 3, 10, 8, 8
S_MAX = PLEN + MAX_NEW + 1
# two pages beyond the slots' 3 x 3, so a recompute after a quarantine finds
# fresh pages
NUM_PAGES = 1 + B * 3 + 2
# layer 0, page 1 (slot 0's first page), row 0, kv head 0, dim 0: a prompt
# KV row every decode step reads
LIVE = (0, 1, 0, 0, 0)
RED = (17, 19)
HALF = 120


@pytest.fixture(scope="module")
def tree():
    return load_npz(CKPT)


@pytest.fixture(scope="module")
def prompts():
    cfg = get_config("qwen3-8b").reduced()
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (B, PLEN)).astype(np.int32)


def _jengine(tree, *, rns_mset=JP21R2, kv_format="rns8r", s_max=S_MAX,
             **kw):
    model = jbuild_model(jget_config("qwen3-8b").reduced(), system="rns",
                         rns_impl="ref", rns_mset=rns_mset)
    return JEngine(model, jtu.tree_map(jnp.asarray, tree), batch=B,
                   s_max=s_max, paged=True, page_size=PS,
                   kv_format=kv_format, num_pages=NUM_PAGES, **kw)


def _tengine(tree, *, rns_mset=P21R2, kv_format="rns8r", s_max=S_MAX, **kw):
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system="rns", rns_mset=rns_mset, device="cpu")
    return ServingEngine(model, from_jax_params(tree, cfg, "cpu"), batch=B,
                         s_max=s_max, page_size=PS, kv_format=kv_format,
                         num_pages=NUM_PAGES, device="cpu", **kw)


def _jgenerate(eng, prompts, faults=None, **kw):
    prev = set_attn_impl("interpret")
    try:
        if faults is None:
            return eng.generate({"tokens": prompts}, max_new=MAX_NEW, **kw)
        with jfaults.inject_faults(eng, faults, after_steps=3) as log:
            out = eng.generate({"tokens": prompts}, max_new=MAX_NEW, **kw)
        assert len(log) == len(faults)
        return out
    finally:
        set_attn_impl(prev)


def _tgenerate(eng, prompts, faults=None, **kw):
    if faults is None:
        return eng.generate({"tokens": prompts}, max_new=MAX_NEW, **kw)
    with tfaults.inject_faults(eng, faults, after_steps=3) as log:
        out = eng.generate({"tokens": prompts}, max_new=MAX_NEW, **kw)
    assert len(log) == len(faults)
    return out


@pytest.fixture(scope="module")
def port_clean(tree, prompts):
    return _tgenerate(_tengine(tree), prompts).tokens


def _reference_model_steps(tree, prompts):
    """Greedy tokens of the reference's model functions called one by one
    (P21R2 weights, rns8r pages), without the engine's jit."""
    jm = jbuild_model(jget_config("qwen3-8b").reduced(), system="rns",
                      rns_impl="ref", rns_mset=JP21R2)
    params = jm.prepare_params(jtu.tree_map(jnp.asarray, tree))
    n_pmax = -(-S_MAX // PS)
    tab = jnp.asarray((1 + np.arange(B * n_pmax)).reshape(B, n_pmax),
                      jnp.int32)
    prev = set_attn_impl("interpret")
    try:
        logits, cache = jm.prefill(params, {"tokens": jnp.asarray(prompts)},
                                   s_max=S_MAX)
        cfg = jm.cfg
        kv = jkv.make_paged_kv(cfg.n_layers, 1 + B * n_pmax, PS, cfg.n_kv,
                               cfg.hd, fmt="rns8r")
        kv = jkv.scatter_prefill(kv, cache.k, cache.v, tab, PS)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out = [tok]
        for i in range(MAX_NEW - 1):
            pos = jnp.full((B,), PLEN + i, jnp.int32)
            logits, kv, syn = jm.decode_paged(params, tok, kv, tab, pos,
                                              page_size=PS,
                                              with_syndrome=True)
            assert int(np.asarray(syn).sum()) == 0
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(tok)
    finally:
        set_attn_impl(prev)
    return np.asarray(jnp.concatenate(out, axis=1))


def _counters(eng) -> dict:
    return dataclasses.asdict(eng.stats.faults)


def test_clean_strict_matches_reference_model_steps(tree, prompts,
                                                    port_clean):
    """P21R2 weights, rns8r pages, policy="strict", no fault: zero counters
    in both packages; the port's tokens equal the reference's model
    functions stepped one by one, and its rns8 tokens (the witnesses change
    nothing)."""
    teng = _tengine(tree, policy="strict")
    tres = _tgenerate(teng, prompts)
    np.testing.assert_array_equal(tres.tokens, port_clean)
    np.testing.assert_array_equal(tres.tokens,
                                  _reference_model_steps(tree, prompts))
    jeng = _jengine(tree, policy="strict")
    jres = _jgenerate(jeng, prompts)
    assert _counters(teng) == _counters(jeng)
    assert not any(_counters(teng).values())
    assert tres.steps == jres.steps == MAX_NEW - 1
    np.testing.assert_array_equal(tres.tokens[:, 0], jres.tokens[:, 0])
    rns8 = _tgenerate(_tengine(tree, kv_format="rns8"), prompts).tokens
    np.testing.assert_array_equal(tres.tokens, rns8)


def _jdouble(engine):
    """Both witnesses of one live K element rewritten to a value outside
    the range: every syndrome fires, the witness decode is out of range --
    detected and uncorrectable (the reference's ``_double_fault``)."""
    kv = engine.pool.kv
    t = kv.k
    arr = np.asarray(t.planes).copy()
    cf = np.moveaxis(arr.view(np.uint8), arr.ndim - 3, 0)
    fmt = jkv.KV_FORMATS["rns8r"]
    dec = int(fmt.pack.decode(jnp.asarray([[int(cf[(0, *LIVE)])]],
                                          jnp.int32))[0, 0])
    v = next(v for v in range(HALF + 1, 240)
             if v % RED[0] != dec % RED[0] and v % RED[1] != dec % RED[1])
    cf[(1, *LIVE)] = v % RED[0]
    cf[(2, *LIVE)] = v % RED[1]
    engine.pool.kv = jkv.PagedKV(
        dataclasses.replace(t, planes=jnp.asarray(arr)), kv.v)
    return LIVE


def _tdouble(engine):
    """The port's :func:`_jdouble`, in place."""
    cf = engine.pool.kv.k.planes.movedim(-3, 0)
    fmt = tkv.KV_FORMATS["rns8r"]
    dec = int(fmt.pack.decode(cf[(0, *LIVE)].reshape(1, 1)
                              .to(torch.int32))[0, 0])
    v = next(v for v in range(HALF + 1, 240)
             if v % RED[0] != dec % RED[0] and v % RED[1] != dec % RED[1])
    cf[(1, *LIVE)] = v % RED[0]
    cf[(2, *LIVE)] = v % RED[1]
    return LIVE


CASES = {
    # name: (engine kwargs, port faults, reference faults)
    "byte": ({"policy": "strict"},
             [tfaults.FaultSpec(kind="kv", which="k", channel=0, at=LIVE,
                                bit=0x20)],
             [jfaults.FaultSpec(kind="kv", which="k", channel=0, at=LIVE,
                                bit=0x20)]),
    "witness": ({"policy": "strict"},
                [tfaults.FaultSpec(kind="kv", which="k", channel=2, at=LIVE,
                                   bit=0x01)],
                [jfaults.FaultSpec(kind="kv", which="k", channel=2, at=LIVE,
                                   bit=0x01)]),
    "detect": ({"policy": "detect"},
               [tfaults.FaultSpec(kind="kv", which="v", channel=1, at=LIVE,
                                  bit=0x01)],
               [jfaults.FaultSpec(kind="kv", which="v", channel=1, at=LIVE,
                                  bit=0x01)]),
    "sticky": ({"policy": "strict", "quarantine_after": 2},
               [tfaults.FaultSpec(kind="kv_sticky", which="k", channel=2,
                                  at=LIVE, bit=0x01)],
               [jfaults.FaultSpec(kind="kv_sticky", which="k", channel=2,
                                  at=LIVE, bit=0x01)]),
    "double_recompute": ({"policy": "strict"}, [_tdouble], [_jdouble]),
    "weight": ({"policy": "strict"},
               [tfaults.FaultSpec(kind="weight", bit=0x11, channel=1,
                                  index=5)],
               [jfaults.FaultSpec(kind="weight", bit=0x11, channel=1,
                                  index=5)]),
    "weight_and_byte_scrub": (
        {"policy": "strict", "scrub": "decode"},
        [tfaults.FaultSpec(kind="weight", bit=0x11, channel=1, index=5),
         tfaults.FaultSpec(kind="kv", which="k", channel=0, at=LIVE,
                           bit=0x20)],
        [jfaults.FaultSpec(kind="weight", bit=0x11, channel=1, index=5),
         jfaults.FaultSpec(kind="kv", which="k", channel=0, at=LIVE,
                           bit=0x20)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_injected_faults_match_reference(tree, prompts, port_clean, name):
    kw, tf, jf = CASES[name]
    teng = _tengine(tree, **kw)
    tres = _tgenerate(teng, prompts, tf)
    jeng = _jengine(tree, **kw)
    _jgenerate(jeng, prompts, jf)
    assert _counters(teng) == _counters(jeng)
    assert teng.pool.quarantined_pages == jeng.pool.quarantined_pages
    assert tres.stats.recomputes == teng.stats.faults.recomputes
    if kw["policy"] != "detect":
        np.testing.assert_array_equal(tres.tokens, port_clean)
    f = teng.stats.faults
    if name == "double_recompute":
        assert f.uncorrected >= 1 and f.recomputes == 1
        assert teng.pool.quarantined_pages == frozenset({LIVE[1]})
    if name == "sticky":
        assert f.pages_quarantined == 1 and f.recomputes >= 1
    if name in ("byte", "witness"):
        assert (f.syndromes, f.detected, f.corrected) == (1, 1, 1)
        assert f.replays >= 1 and f.recomputes == 0


@pytest.mark.parametrize("name", ["byte", "double_recompute"])
def test_sampled_replay_draws_the_clean_tokens(tree, prompts, port_clean,
                                               name):
    """temperature > 0: a replay after a repair ("byte") and a strict
    recompute ("double_recompute") restart the sampler from the state the
    segment began with, so they draw the clean sampled run's tokens."""
    kw, tf, _ = CASES[name]

    def run(faults):
        eng = _tengine(tree, **kw)
        res = _tgenerate(eng, prompts, faults, temperature=1.0,
                         generator=torch.Generator().manual_seed(7))
        return eng.stats.faults, res.tokens

    _, clean = run(None)
    assert (clean != port_clean).any()      # sampled, not greedy
    f, tokens = run(tf)
    assert f.replays >= 1 if name == "byte" else f.recomputes == 1
    np.testing.assert_array_equal(tokens, clean)


def test_rotating_scrub_repairs_weight_fault(tree, prompts, port_clean):
    """scrub="rotate:2": the first segment checks the even units, the
    second the odd ones, which hold weight leaf 1 where the fault landed in
    between; it is found and repaired."""
    eng = _tengine(tree, scrub="rotate:2")
    res = _tgenerate(eng, prompts, [tfaults.FaultSpec(
        kind="weight", bit=0x05, channel=2, index=11, leaf=1)])
    np.testing.assert_array_equal(res.tokens, port_clean)
    f = eng.stats.faults
    assert f.detected == f.corrected == 1 and f.weight_scrubs == 2


def test_policy_validation(tree):
    with pytest.raises(ValueError, match="policy"):
        _tengine(tree, policy="paranoid")
    with pytest.raises(ValueError, match="rns8r"):
        _tengine(tree, policy="strict", kv_format="rns8")
    with pytest.raises(ValueError, match="quarantine_after"):
        _tengine(tree, policy="strict", quarantine_after=0)
    with pytest.raises(ValueError, match="scrub"):
        _tengine(tree, scrub="sometimes")
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(ValueError, match="rns_mset"):
        build_model(cfg, system="bns", rns_mset=P21R2, device="cpu")


@pytest.mark.parametrize("cls", [KVPagePool, JPool])
def test_pool_quarantine_semantics(cls):
    """Mirrors ``tests/test_fault_policy.py::test_pool_quarantine_semantics``
    on both pools."""
    pool = cls(1, 6, 4, 2, 8, **({"device": "cpu"} if cls is KVPagePool
                                 else {}))
    assert pool.quarantine(0) is False         # the dump page is immune
    assert pool.quarantine(3) is True
    assert pool.quarantine(3) is False         # idempotent
    assert pool.quarantined_pages == frozenset({3})
    assert 3 not in pool._free
    pool.reset()                               # sticky hardware: survives
    assert 3 not in pool._free
    got = pool.alloc(4)                        # all remaining usable pages
    assert 3 not in got
    with pytest.raises(RuntimeError, match="quarantined"):
        pool.alloc(1)
    pool.release(got)
    assert 3 not in pool._free
    assert pool.note_fault(5) == 1 and pool.note_fault(5) == 2


# ---------------------------------------------------------------------------
# generate(eos=, active=, prompt_len=) on bf16 pages (bit-identical path)
# ---------------------------------------------------------------------------


def _eos_engines(tree):
    return (_tengine(tree, rns_mset=None, kv_format="bf16", s_max=24),
            _jengine(tree, rns_mset=None, kv_format="bf16", s_max=24))


@pytest.mark.parametrize("case", ["eos_halt", "eos_one_slot", "prompt_len"])
def test_generate_eos_active_prompt_len_match_reference(tree, prompts, case):
    teng, jeng = _eos_engines(tree)
    clean = _tgenerate(teng, prompts).tokens
    first = [[int(np.argmax(clean[b] == clean[b, t])) for t in
              range(MAX_NEW)] for b in range(B)]
    if case == "eos_halt":
        # slot 0 stops at its 3rd token, slot 1 at its 5th (or where that
        # token first shows), slot 2 is inactive: the loop halts early
        kw = dict(eos=np.array([clean[0, 2], clean[1, 4], -1]),
                  active=np.array([True, True, False]))
        steps = max(first[0][2], first[1][4])
    elif case == "eos_one_slot":
        # one slot's EOS does not stop the others
        kw = dict(eos=np.array([clean[0, 1], -1, -1]))
        steps = MAX_NEW - 1
    else:
        kw = dict(prompt_len=PLEN + 3, eos=int(clean[2, 6]))
        steps = None
    tres = _tgenerate(teng, prompts, **kw)
    jres = _jgenerate(jeng, prompts, **kw)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    assert tres.steps == jres.steps
    assert tres.tokens.shape == (B, 1 + tres.steps)
    if steps is not None:
        assert tres.steps == steps
        np.testing.assert_array_equal(tres.tokens, clean[:, :1 + steps])
