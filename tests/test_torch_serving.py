"""Port parity end to end: the committed qwen3-8b checkpoint served by both
packages.

The checkpoint is the ``.reduced()`` shape (2 layers, d_model 64, f32
compute).  Its parameters go through ``load_npz`` -> ``from_jax_params``
into the port, and as jnp arrays into the JAX package.  The reference runs
its residue matmuls through its exact ``ref`` backend (``rns_impl="ref"``)
and its attention through its Pallas kernels in interpret mode: its ``ref``
paged-decode path does not round ``p`` to bf16 before the PV product as its
kernel (and the port's) does on bf16 pages.

Tolerances: prefill logits agree to ``LOGIT_TOL`` (absolute, on logits of
magnitude ~1).  They are not bit-identical because float sums run in a
different order (torch CPU vs XLA CPU: rmsnorm, rope, attention), which
moves activations by a few f32 ulps; an int4 activation code then flips
only when a value sits within those ulps of a rounding tie, and a flipped
code would move a logit by one quantization step (~1e-2), far above the
float noise (~1e-6).  Greedy tokens must be identical.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.numerics import kv_pages as jkv
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServingEngine

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")
LOGIT_TOL = 1e-4
B, PLEN, MAX_NEW, PS = 3, 10, 8, 8
S_MAX = PLEN + MAX_NEW + 1


@pytest.fixture(scope="module")
def tree():
    return load_npz(CKPT)


@pytest.fixture(scope="module")
def prompts():
    cfg = get_config("qwen3-8b").reduced()
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (B, PLEN)).astype(np.int32)


def _reference(system):
    return jbuild_model(jget_config("qwen3-8b").reduced(), system=system,
                        rns_impl="ref" if system == "rns" else None)


def _reference_engine(tree, prompts, system, kv_format):
    prev = set_attn_impl("interpret")
    try:
        eng = JEngine(_reference(system), jtu.tree_map(jnp.asarray, tree),
                      batch=B, s_max=S_MAX, paged=True, page_size=PS,
                      kv_format=kv_format)
        return eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    finally:
        set_attn_impl(prev)


def _reference_model_steps(tree, prompts, kv_format):
    """Greedy tokens from the reference's model functions called one by one
    (prefill, scatter_prefill, decode_paged), without the engine's jit."""
    jm = _reference("rns")
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
                               cfg.hd, fmt=kv_format)
        kv = jkv.scatter_prefill(kv, cache.k, cache.v, tab, PS)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out = [tok]
        for i in range(MAX_NEW - 1):
            pos = jnp.full((B,), PLEN + i, jnp.int32)
            logits, kv = jm.decode_paged(params, tok, kv, tab, pos,
                                         page_size=PS)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(tok)
    finally:
        set_attn_impl(prev)
    return np.asarray(jnp.concatenate(out, axis=1))


def _port_generate(tree, prompts, system, kv_format):
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system=system, device="cpu")
    eng = ServingEngine(model, from_jax_params(tree, cfg, "cpu"), batch=B,
                        s_max=S_MAX, page_size=PS, kv_format=kv_format,
                        device="cpu")
    res = eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    assert res.steps == MAX_NEW - 1
    assert res.stats.pages_allocated == res.stats.pages_freed > 0
    return res


def test_config_copy_matches_reference():
    assert get_config("qwen3-8b").__dict__ == \
        jget_config("qwen3-8b").__dict__
    assert get_config("qwen3-8b").reduced().__dict__ == \
        jget_config("qwen3-8b").reduced().__dict__


def test_prepared_params_bit_exact(tree):
    """Planes and scales the port derives equal the reference's
    ``prepare_params`` output bit for bit (every layer, and the tied
    logits weight)."""
    cfg = get_config("qwen3-8b").reduced()
    jp = _reference("rns").prepare_params(jtu.tree_map(jnp.asarray, tree))
    tp = build_model(cfg, system="rns", device="cpu").prepare_params(
        from_jax_params(tree, cfg, "cpu"))
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
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.mark.parametrize("system,kv_format", [
    ("rns", "rns4"), ("rns", "bf16"), ("bns", "bf16")])
def test_generate_matches_reference_engine(tree, prompts, system, kv_format):
    jr = _reference_engine(tree, prompts, system, kv_format)
    tr = _port_generate(tree, prompts, system, kv_format)
    np.testing.assert_allclose(tr.prefill_logits, jr.prefill_logits,
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.steps == jr.steps


def test_generate_rns8_matches_reference_model_steps(tree, prompts):
    """rns8 pages: the tokens equal the reference's model functions driven
    step by step.  The reference's engine compiles its page quantizer, and
    XLA rewrites ``amax / qmax`` there into ``amax * (1 / qmax)``: its page
    scales sit one ulp off its own ``quantize_to_format`` (see
    ``test_torch_kv_pages.py``), which on these prompts flips a page byte
    at a rounding tie and moves two later tokens.  The prefill, which no
    page quantizer touches, still agrees with the reference engine."""
    tr = _port_generate(tree, prompts, "rns", "rns8")
    np.testing.assert_array_equal(
        tr.tokens, _reference_model_steps(tree, prompts, "rns8"))
    jr = _reference_engine(tree, prompts, "rns", "rns8")
    np.testing.assert_allclose(tr.prefill_logits, jr.prefill_logits,
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tr.tokens[:, 0], jr.tokens[:, 0])
