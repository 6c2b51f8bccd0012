"""Speculative decoding in the port against the JAX package.

Unit parity: ``accept_blocks`` and ``SpecConfig.parse`` (errors included)
on random drafts, greedy rows, EOS tokens, budgets and live masks; the
n-gram drafter's ``propose`` / ``observe`` on random histories;
``numerics.attention.paged_verify`` against the reference's, run in
interpret mode, on bf16, rns8 and rns8r pages and with g > 1 (fp32 2e-5,
the tolerance of tests/test_flash_attn.py); the rns drafter's derived P16
3-bit planes bit for bit.

End to end on the committed reduced qwen3-8b checkpoint (``system="rns"``):
one ``verify_paged`` call equals V sequential ``decode_paged`` steps bit for
bit (logits and page bytes); the port's speculative tokens and SpecStats
equal the JAX engine's for ``ngram:4`` and ``rns:3`` on bf16 and rns4 pages
(the formats on which tests/test_torch_serving.py holds the two engines
equal), with an EOS set on two of the three slots; on rns8 and rns8r pages
they equal the port's plain tokens (the reference engine's compiled page
quantizer is one ulp off there, ROADMAP §C); and the ``spec=`` knob
refuses what the reference's refuses.
"""
from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import asdict

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.numerics import attention as jattn
from repro.numerics import kv_pages as jkv
from repro.serving import drafters as jdr
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.serving.spec import accept_blocks as jaccept
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.models.api import build_model
from repro_torch.numerics import attention as tattn
from repro_torch.numerics import kv_pages as tkv
from repro_torch.serving import drafters as tdr
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig, accept_blocks

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")
TOL = 2e-5
B, PLEN, MAX_NEW, PS = 3, 10, 12, 8
S_MAX = PLEN + MAX_NEW + 1


@pytest.fixture(scope="module")
def tree():
    return load_npz(CKPT)


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen3-8b").reduced()


@pytest.fixture(scope="module")
def prompts(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)


@pytest.fixture(scope="module")
def port(tree, cfg):
    model = build_model(cfg, system="rns", device="cpu")
    return model, from_jax_params(tree, cfg, "cpu")


def _generate(port, prompts, kv_format, spec=None, **kw):
    model, params = port
    eng = ServingEngine(model, params, batch=B, s_max=S_MAX, page_size=PS,
                        kv_format=kv_format, device="cpu", spec=spec)
    return eng, eng.generate({"tokens": prompts}, max_new=MAX_NEW, **kw)


# ---------------------------------------------------------------------------
# The knob and the acceptance rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_accept_blocks_matches_reference(seed):
    """Random drafts against greedy rows that agree on random prefixes,
    EOS tokens inside and outside the blocks, budgets from 0 up and dead
    slots."""
    rng = np.random.default_rng(seed)
    nb, k, vocab = 64, 1 + seed, 5
    greedy = rng.integers(0, vocab, (nb, k + 1))
    drafts = greedy[:, :k].copy()
    cut = rng.integers(0, k + 1, nb)            # first disagreement
    for b in range(nb):
        if cut[b] < k:
            drafts[b, cut[b]] = (greedy[b, cut[b]] + 1) % vocab
    drafts = np.where(rng.random((nb, k)) < 0.1,
                      rng.integers(0, vocab, (nb, k)), drafts)
    eos = np.where(rng.random(nb) < 0.5, rng.integers(0, vocab, nb), -1)
    budget = rng.integers(0, k + 3, nb)
    live = rng.random(nb) < 0.8
    jm, jn = jaccept(jnp.asarray(drafts, jnp.int32),
                     jnp.asarray(greedy, jnp.int32), eos=jnp.asarray(eos),
                     budget=jnp.asarray(budget), live=jnp.asarray(live))
    tm, tn = accept_blocks(torch.from_numpy(drafts), torch.from_numpy(greedy),
                           eos=torch.from_numpy(eos),
                           budget=torch.from_numpy(budget),
                           live=torch.from_numpy(live))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("text", ["ngram", "rns", "ngram:2", "rns:7",
                                  "medusa:4", "ngram:0", "rns:-1", "ngram:x",
                                  "", 4, None])
def test_spec_config_parse_matches_reference(text):
    def outcome(cls):
        try:
            c = cls.parse(text)
        except (ValueError, TypeError) as e:
            return type(e)
        return (c.drafter, c.k, c.ngram_n, c.draft_qbits, c.draft_mset)

    assert outcome(SpecConfig) == outcome(JSpecConfig)


@pytest.mark.parametrize("n,k", [(2, 4), (3, 3), (1, 2)])
def test_ngram_drafter_matches_reference(n, k):
    """propose on random repetitive histories at random positions (matches,
    misses, contexts before the stream start), then observe with random
    blocks, counts and dead slots: drafts and histories equal."""
    rng = np.random.default_rng(10 * n + k)
    nb, hist_cap = 6, 40
    jd = jdr.NGramDrafter(k, n=n, batch=nb, hist_cap=hist_cap)
    td = tdr.NGramDrafter(k, n=n, hist_cap=hist_cap, device="cpu")
    hist = rng.integers(0, 4, (nb, jd.cap))
    jstate = {"hist": jnp.asarray(hist, jnp.int32)}
    tstate = td.init_state(nb)
    tstate["hist"][:, :td.cap] = torch.from_numpy(hist)
    for _ in range(5):
        pos = rng.integers(0, hist_cap, nb)
        pos[0] = 0
        jdrafts, jstate = jd.propose(jstate, None, jnp.asarray(pos, jnp.int32),
                                     None)
        tdrafts, tstate = td.propose(tstate, None, torch.from_numpy(pos),
                                     None)
        np.testing.assert_array_equal(tdrafts.numpy(), np.asarray(jdrafts))
        block = rng.integers(0, 4, (nb, k + 1))
        m = rng.integers(0, k + 2, nb)
        m[1] = 0
        obs_pos = pos.copy()
        obs_pos[2] = jd.cap - 2                 # writes past the history
        jstate = jd.observe(jstate, jnp.asarray(block, jnp.int32),
                            jnp.asarray(m, jnp.int32),
                            jnp.asarray(obs_pos, jnp.int32), None)
        tstate = td.observe(tstate, torch.from_numpy(block),
                            torch.from_numpy(m), torch.from_numpy(obs_pos),
                            None)
        np.testing.assert_array_equal(tstate["hist"][:, :td.cap].numpy(),
                                      np.asarray(jstate["hist"]))


# ---------------------------------------------------------------------------
# The folded verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["bf16", "rns8", "rns8r"])
@pytest.mark.parametrize("H,Kv", [(4, 4), (8, 2)], ids=["g1", "g4"])
def test_paged_verify_matches_reference(fmt, H, Kv):
    """V = 5 rows a slot at consecutive kv_len, one row past the block
    table's dump-page entry: the port's folded paged decode against the
    reference's paged_verify in interpret mode."""
    nb, ps, n_pmax, hd, V = 3, 8, 4, 16, 5
    P = 1 + nb * n_pmax
    rng = np.random.default_rng(H + len(fmt))
    dense = rng.normal(0, 1, (2, 1, nb, n_pmax * ps, Kv, hd)).astype(
        np.float32)
    if fmt == "bf16":
        dense = np.asarray(jnp.asarray(dense, jnp.bfloat16)
                           .astype(jnp.float32))
    tab = (1 + rng.permutation(nb * n_pmax)).reshape(nb, n_pmax).astype(
        np.int32)
    tab[2, 3] = 0
    kv_len = np.array([1, 20, 23], np.int32)[:, None] + np.arange(V)[None]
    q = rng.normal(0, 1, (nb, V, H, hd)).astype(np.float32)
    jp = jkv.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt)
    jp = jkv.scatter_prefill(jp, jnp.asarray(dense[0]), jnp.asarray(dense[1]),
                             jnp.asarray(tab), ps)
    tp = tkv.make_paged_kv(1, P, ps, Kv, hd, fmt=fmt, device="cpu")
    tkv.scatter_prefill(tp, torch.tensor(dense[0]), torch.tensor(dense[1]),
                        torch.from_numpy(tab), ps)
    j = jattn.paged_verify(jnp.asarray(q), jkv.layer_slice(jp, 0),
                           jnp.asarray(tab), jnp.asarray(kv_len),
                           page_size=ps, backend="interpret")
    t = tattn.paged_verify(torch.from_numpy(q), tkv.layer_slice(tp, 0),
                           torch.from_numpy(tab), torch.from_numpy(kv_len),
                           page_size=ps)
    assert t.dtype == torch.float32 and t.shape == (nb, V, H, hd)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def _leaves(kv):
    out = []
    for t in kv:
        out += [t.planes, t.scale] if hasattr(t, "planes") else [t]
    return out


@pytest.mark.parametrize("fmt", ["bf16", "rns8", "rns4"])
def test_verify_rows_equal_sequential_decode(port, cfg, fmt):
    """One verify_paged call of V = 5 tokens a slot, the last past the
    allocated pages (its row goes to the dump page), equals 5 decode_paged
    steps bit for bit: every logits row, and every page byte the slots
    own."""
    model, params = port
    params = model.prepare_params(params)
    nb, ps, n_pmax, V, plen = 3, 8, 2, 5, 12
    rng = np.random.default_rng(7)
    _, cache = model.prefill(params, rng.integers(0, cfg.vocab, (nb, plen)),
                             s_max=n_pmax * ps)
    pool = tkv.make_paged_kv(cfg.n_layers, 1 + nb * n_pmax, ps, cfg.n_kv,
                             cfg.hd, fmt=fmt, device="cpu")
    tab = torch.arange(1, 1 + nb * n_pmax, dtype=torch.int32).reshape(
        nb, n_pmax)
    tkv.scatter_prefill(pool, cache[0], cache[1], tab, ps)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (nb, V)))
    pos0 = torch.full((nb,), plen, dtype=torch.int32)
    seq = tkv.PagedKV(*(tkv.make_paged_kv(
        cfg.n_layers, 1 + nb * n_pmax, ps, cfg.n_kv, cfg.hd, fmt=fmt,
        device="cpu")))
    for a, b in zip(_leaves(seq), _leaves(pool)):
        a.copy_(b)
    rows = []
    for j in range(V - 1):      # the last row lies past the table
        logits, seq = model.decode_paged(params, toks[:, j:j + 1], seq, tab,
                                         pos0 + j, page_size=ps)
        rows.append(logits)
    logits_v, pool = model.verify_paged(params, toks, pool, tab, pos0,
                                        page_size=ps)
    assert logits_v.shape == (nb, V, cfg.vocab)
    for j in range(V - 1):
        assert torch.equal(logits_v[:, j], rows[j]), f"row {j}"
    for a, b in zip(_leaves(seq), _leaves(pool)):
        assert torch.equal(a[:, 1:], b[:, 1:])      # page 0 is the dump


def test_derive_draft_params_matches_reference(tree, cfg):
    """The rns drafter's P16 3-bit planes and scales, every weight and the
    tied logits weight, equal the reference's bit for bit."""
    from repro.core.moduli import P16 as JP16
    from repro_torch.core.moduli import P16

    jt = jbuild_model(jget_config("qwen3-8b").reduced(), system="rns",
                      rns_impl="ref")
    jp = jdr.derive_draft_params(
        jt.prepare_params(jtu.tree_map(jnp.asarray, tree)),
        jbuild_model(jt.cfg, system="rns", rns_bits=3, rns_mset=JP16,
                     rns_impl="ref"))
    tt = build_model(cfg, system="rns", device="cpu")
    tp = tdr.derive_draft_params(
        tt.prepare_params(from_jax_params(tree, cfg, "cpu")),
        build_model(cfg, system="rns", rns_bits=3, rns_mset=P16,
                    device="cpu"))
    pairs = [(tp["embed"]["logits_w"], jp["embed"]["logits_w"])]
    for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                         ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            j = jp["layers"][group][name]["w"]
            for i, layer in enumerate(tp["layers"]):
                pairs.append((layer[group][name]["w"],
                              type(j)(j.planes[i], j.scale[i], j.mset,
                                      j.layout, j.qbits, j.max_abs)))
    for t, j in pairs:
        assert t.mset.moduli == (31, 32, 33) and t.qbits == 3
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_tokens(port, prompts):
    return {fmt: _generate(port, prompts, fmt)[1].tokens
            for fmt in ("bf16", "rns4", "rns8", "rns8r")}


def _eos(plain):
    """Slot 0 stops at its 5th token (inside a block), slot 1 runs to its
    budget, slot 2 stops at its 8th."""
    return np.array([plain[0, 4], -1, plain[2, 7]], np.int64)


@pytest.mark.parametrize("kv_format", ["bf16", "rns4"])
@pytest.mark.parametrize("spec", ["ngram:4", "rns:3"])
def test_spec_matches_reference_engine(tree, port, prompts, plain_tokens,
                                       spec, kv_format):
    """The JAX engine (rns_impl="ref", attention in interpret mode) and the
    port give the same speculative tokens, zeros past an EOS included, and
    the same SpecStats."""
    eos = _eos(plain_tokens[kv_format])
    prev = set_attn_impl("interpret")
    try:
        je = JEngine(jbuild_model(jget_config("qwen3-8b").reduced(),
                                  system="rns", rns_impl="ref"),
                     jtu.tree_map(jnp.asarray, tree), batch=B, s_max=S_MAX,
                     paged=True, page_size=PS, kv_format=kv_format,
                     spec=spec)
        jr = je.generate({"tokens": prompts}, max_new=MAX_NEW, eos=eos)
    finally:
        set_attn_impl(prev)
    te, tr = _generate(port, prompts, kv_format, spec=spec, eos=eos)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert asdict(te.stats.spec) == asdict(je.stats.spec)
    assert asdict(tr.stats.spec) == asdict(jr.stats.spec)
    assert tr.steps == jr.steps


@pytest.mark.parametrize("kv_format", ["rns8", "rns8r"])
@pytest.mark.parametrize("spec", ["ngram:4", "rns:3"])
def test_spec_equals_plain_on_residue_pages(port, prompts, plain_tokens,
                                            spec, kv_format):
    eng, res = _generate(port, prompts, kv_format, spec=spec)
    np.testing.assert_array_equal(res.tokens, plain_tokens[kv_format])
    sp = eng.stats.spec
    assert sp.verify_steps == res.steps and 0 < sp.blocks
    assert sp.proposed == sp.blocks * eng.spec.k
    assert 0 <= sp.accepted <= sp.proposed
    assert sp.emitted == B * (MAX_NEW - 1) == res.stats.spec.emitted
    assert 1.0 <= sp.mean_accepted_len <= eng.spec.k + 1


def test_spec_eos_inside_accepted_block(port, prompts, plain_tokens):
    """Each row equals plain decoding through its own EOS and holds zeros
    after it, as the reference's speculative rows do; the slot without an
    EOS runs to its budget."""
    eos = _eos(plain_tokens["rns8"])
    _, plain = _generate(port, prompts, "rns8", eos=eos)
    _, res = _generate(port, prompts, "rns8", spec="ngram:4", eos=eos)
    stops = []
    for b in range(B):
        hits = np.nonzero(plain.tokens[b] == eos[b])[0]
        stops.append(hits[0] + 1 if hits.size else MAX_NEW)
        np.testing.assert_array_equal(res.tokens[b, :stops[-1]],
                                      plain.tokens[b, :stops[-1]])
        assert (res.tokens[b, stops[-1]:] == 0).all()
    assert stops[1] == MAX_NEW and max(stops[0], stops[2]) < MAX_NEW
    # the first token comes from the prefill, the rest from the verifies
    assert res.stats.spec.emitted == sum(stops) - B


def test_spec_knob_refusals(port, prompts):
    """Refused as in the reference: no paged serving (paged=False, or a
    family without a paged decode), a fault policy, temperature sampling,
    and bad drafter strings."""
    model, params = port
    kw = dict(batch=B, s_max=S_MAX, page_size=PS, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, paged=False, spec="ngram:4", **kw)
    hyb = build_model(get_config("zamba2-7b").reduced(), system="bns",
                      device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(hyb, hyb.init(0), spec="ngram:4", **kw)
    with pytest.raises(ValueError, match="policy"):
        ServingEngine(model, params, kv_format="rns8r", policy="detect",
                      spec="ngram:4", **kw)
    for bad in ("medusa:4", "ngram:0"):
        with pytest.raises(ValueError):
            ServingEngine(model, params, spec=bad, **kw)
    eng = ServingEngine(model, params, spec="ngram:2", **kw)
    with pytest.raises(ValueError, match="greedy"):
        eng.generate({"tokens": prompts}, max_new=4, temperature=0.7,
                     generator=torch.Generator().manual_seed(0))


def test_serve_cli_spec():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--reduced", "--system", "rns", "--kv-format", "rns8",
         "--device", "cpu", "--batch", "2", "--max-new", "6", "--spec",
         "ngram:4"], capture_output=True, text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(
            os.path.dirname(__file__), "..", "src"), OMP_NUM_THREADS="1"))
    assert "[serve] spec=ngram:4: " in out.stdout
    assert "verify steps for 10 tokens" in out.stdout
