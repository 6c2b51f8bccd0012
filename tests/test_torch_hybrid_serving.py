"""Port parity on the dense-cache decode path: the hybrid family (reduced
zamba2-7b, Mamba2 layers and a shared attention block) and the dense family
with ``paged=False`` (the committed reduced qwen3-8b checkpoint).

The reduced zamba2 has random weights from ``jax.random.PRNGKey(0)``,
carried into the port as numpy through ``convert.from_jax_params``.  The
reference runs its residue matmuls through its exact ``ref`` backend and
its attention through its Pallas kernels in interpret mode (its ``ref``
decode does not round ``p`` to the cache dtype as its kernel and the
port's do).

Tolerances: prefill logits ``LOGIT_TOL`` (f32 compute; float sums in
another order move activations by a few ulps, and an int4 activation code
flips only at a rounding tie; a flipped code would move a logit by ~1e-2).
Teacher-forced decode logits ``DECODE_TOL``: on top of that, both sides
round the softmax weights ``p`` to the bf16 cache dtype before the PV
product, and an ``exp`` one f32 ulp apart can round to the neighbouring
bf16 value (2**-8 of one weight).  Greedy tokens must be identical.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.core.moduli import P21R2
from repro_torch.models.api import build_model
from repro_torch.numerics.attention import set_decode_block
from repro_torch.serving.engine import ServingEngine

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-3
B, PLEN, MAX_NEW = 3, 8, 6      # PLEN: one SSM chunk of the reduced zamba2
S_MAX = PLEN + MAX_NEW + 1
QLEN = 10                       # qwen3 prompts (prefill spans 3 pages of 4)


def _jmodel(arch, system):
    return jbuild_model(jget_config(arch).reduced(), system=system,
                        rns_impl="ref" if system == "rns" else None)


@pytest.fixture(scope="module")
def hybrid_tree():
    params = _jmodel("zamba2-7b", "bns").init(jax.random.PRNGKey(0))
    return jtu.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def qwen_tree():
    return load_npz(CKPT)


def _prompts(cfg, n):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, n)).astype(
        np.int32)


def _port(arch, tree, system, **kw):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, system=system, device="cpu", **kw)
    return model, from_jax_params(tree, cfg, "cpu")


def _reference_generate(arch, tree, prompts, system, **kw):
    prev = set_attn_impl("interpret")
    try:
        eng = JEngine(_jmodel(arch, system), jtu.tree_map(jnp.asarray, tree),
                      batch=B, s_max=prompts.shape[1] + MAX_NEW + 1, **kw)
        assert not eng.paged
        return eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    finally:
        set_attn_impl(prev)


def test_config_copy_matches_reference():
    for cfg in (get_config("zamba2-7b"), get_config("zamba2-7b").reduced()):
        ref = jget_config("zamba2-7b")
        ref = ref if cfg.n_layers == ref.n_layers else ref.reduced()
        assert cfg.__dict__ == ref.__dict__


def test_hybrid_tree_converts(hybrid_tree):
    cfg = get_config("zamba2-7b").reduced()
    p = from_jax_params(hybrid_tree, cfg, "cpu")
    assert len(p["layers"]) == cfg.n_layers
    assert set(p["layers"][0]) == {"norm", "mamba"}
    assert set(p["shared"]) == {"in_proj", "attn_norm", "attn", "mlp_norm",
                                "mlp"}
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(hybrid_tree, get_config("zamba2-7b"), "cpu")


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_hybrid_logits_match_reference_model(hybrid_tree, system):
    """Prefill, then teacher-forced decode steps over the dense cache,
    against the reference's model functions."""
    cfg = get_config("zamba2-7b").reduced()
    jm = _jmodel("zamba2-7b", system)
    jp = jm.prepare_params(jtu.tree_map(jnp.asarray, hybrid_tree))
    tm, tp = _port("zamba2-7b", hybrid_tree, system)
    tp = tm.prepare_params(tp)
    toks = _prompts(cfg, PLEN + MAX_NEW)
    prev = set_attn_impl("interpret")
    try:
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PLEN])},
                            s_max=S_MAX)
        tl, tc = tm.prefill(tp, toks[:, :PLEN], s_max=S_MAX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
        # the prefill's bf16 KV within one bf16 rounding step (2**-7
        # relative): inputs a few f32 ulps apart can straddle a boundary
        for t, j in ((tc["attn"].k, jc["attn"].k),
                     (tc["attn"].v, jc["attn"].v)):
            assert tuple(t.shape) == tuple(j.shape)
            assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j.astype(jnp.float32)),
                                       rtol=2 ** -7, atol=1e-6)
        for i in range(MAX_NEW):
            t = toks[:, PLEN + i: PLEN + i + 1]
            jl, jc = jm.decode(jp, jnp.asarray(t), jc, jnp.int32(PLEN + i))
            tl, tc = tm.decode(tp, t, tc, PLEN + i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=DECODE_TOL)
    finally:
        set_attn_impl(prev)
    # the f32 SSM state and conv history after the steps
    for t, j in ((tc["ssm"].state, jc["ssm"].state),
                 (tc["ssm"].conv, jc["ssm"].conv)):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=DECODE_TOL)


def test_init_cache_layouts():
    hcfg = get_config("zamba2-7b").reduced()
    c = build_model(hcfg, device="cpu").init_cache(2, 12)
    assert c["ssm"].conv.shape == (4, 2, 3, 160)
    assert c["ssm"].state.shape == (4, 2, 8, 16, 16)
    assert c["ssm"].state.dtype == torch.float32
    assert c["attn"].k.shape == (2, 2, 12, 4, 16)
    assert c["attn"].k.dtype == torch.bfloat16
    qcfg = get_config("qwen3-8b").reduced()
    c = build_model(qcfg, device="cpu").init_cache(2, 12)
    assert c.k.shape == c.v.shape == (2, 2, 12, qcfg.n_kv, 16)


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_hybrid_generate_matches_reference_engine(hybrid_tree, system):
    cfg = get_config("zamba2-7b").reduced()
    prompts = _prompts(cfg, PLEN)
    jr = _reference_generate("zamba2-7b", hybrid_tree, prompts, system)
    model, params = _port("zamba2-7b", hybrid_tree, system)
    assert model.decode_paged is None
    eng = ServingEngine(model, params, batch=B, s_max=S_MAX, device="cpu")
    assert not eng.paged and eng.pool is None
    tr = eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    np.testing.assert_allclose(tr.prefill_logits, jr.prefill_logits,
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.steps == jr.steps == MAX_NEW - 1


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_qwen3_dense_generate_matches_reference_engine(qwen_tree, system):
    """qwen3-8b with ``paged=False`` on the committed checkpoint, against
    the reference's dense engine."""
    cfg = get_config("qwen3-8b").reduced()
    prompts = _prompts(cfg, QLEN)
    jr = _reference_generate("qwen3-8b", qwen_tree, prompts, system,
                             paged=False)
    model, params = _port("qwen3-8b", qwen_tree, system)
    eng = ServingEngine(model, params, batch=B, s_max=QLEN + MAX_NEW + 1,
                        paged=False,
                        kv_format="rns8", device="cpu")
    assert not eng.paged and eng.pool is None    # kv_format is not used
    tr = eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    np.testing.assert_allclose(tr.prefill_logits, jr.prefill_logits,
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.steps == jr.steps


def test_dense_equals_bf16_pages_at_page_size(qwen_tree):
    """The dense engine against the same model on bf16 pages with the
    decode chunk set to the page size (the reference's own pin,
    ``tests/test_paged_serving.py``): tokens, prefill logits and steps bit
    for bit, greedy and with an EOS, over multi-page prompts."""
    cfg = get_config("qwen3-8b").reduced()
    model, params = _port("qwen3-8b", qwen_tree, "rns")
    kw = dict(batch=B, s_max=QLEN + MAX_NEW + 1, page_size=4, device="cpu")
    dense = ServingEngine(model, params, paged=False, **kw)
    paged = ServingEngine(model, params, kv_format="bf16", **kw)
    assert paged.paged and paged.n_pmax == 5
    prompts = _prompts(cfg, QLEN)
    prev = set_decode_block(4)
    try:
        for eos in (None, int(dense.generate(
                {"tokens": prompts}, max_new=3).tokens[0, 1])):
            rd = dense.generate({"tokens": prompts}, max_new=MAX_NEW,
                                eos=eos)
            rp = paged.generate({"tokens": prompts}, max_new=MAX_NEW,
                                eos=eos)
            np.testing.assert_array_equal(rd.tokens, rp.tokens)
            np.testing.assert_array_equal(rd.prefill_logits,
                                          rp.prefill_logits)
            assert rd.steps == rp.steps
    finally:
        set_decode_block(prev)


def test_dense_engine_options(hybrid_tree):
    """The options that belong to pages: a policy raises without them, a
    paged=True request falls back to the dense cache for a family without
    a paged decode, and the weight scrub still runs before the loop."""
    model, params = _port("zamba2-7b", hybrid_tree, "rns", rns_mset=P21R2)
    with pytest.raises(ValueError, match="rns8r"):
        ServingEngine(model, params, batch=B, s_max=S_MAX, device="cpu",
                      kv_format="rns8r", policy="detect")
    eng = ServingEngine(model, params, batch=B, s_max=S_MAX, paged=True,
                        device="cpu", scrub="decode")
    assert not eng.paged
    prompts = _prompts(get_config("zamba2-7b").reduced(), PLEN)
    res = eng.generate({"tokens": prompts}, max_new=2,
                       eos=np.array([-1, -1, -1]),
                       active=np.array([False, False, False]))
    assert res.tokens.shape == (B, 1) and res.steps == 0
    assert eng.stats.faults.weight_scrubs == 1
    assert eng.stats.faults.kv_scrubs == 0


def test_cli_serves_reduced_hybrid(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "zamba2-7b", "--reduced", "--system", "rns",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--max-new", "3"]) == 0
    assert "zamba2-7b system=rns kv=dense" in capsys.readouterr().out
