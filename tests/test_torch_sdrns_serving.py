"""Port parity end to end under ``system="sdrns"``: the committed qwen3-8b
checkpoint (the ``.reduced()`` shape: 2 layers, d_model 64, f32 compute)
served on P21 signed-digit weight planes with rns8 KV pages.

The reference runs its SD-RNS Pallas kernels in interpret mode
(``rns_impl="interpret"``) and its attention kernels in interpret mode,
and is stepped through its model functions (prefill, scatter_prefill,
decode_paged) as ``test_torch_serving.py`` does for rns8 pages: its jitted
engine's page quantizer drifts one ulp (ROADMAP C).

Tolerances: the integer paths are exact (planes bit for bit; the sdrns
serve's logits and tokens equal the port's own rns serve's bit for bit,
since both compute the same exact integer products).  Against the
reference, prefill logits agree to ``LOGIT_TOL`` (float sums in another
order: rmsnorm, rope, attention) and greedy tokens are identical.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.numerics import kv_pages as jkv
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServingEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "qwen3-8b", "ckpt_0000000002.npz")
LOGIT_TOL = 1e-4
B, PLEN, MAX_NEW, PS = 2, 8, 6, 8
S_MAX = PLEN + MAX_NEW + 1


@pytest.fixture(scope="module")
def tree():
    return load_npz(CKPT)


@pytest.fixture(scope="module")
def prompts():
    cfg = get_config("qwen3-8b").reduced()
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)


def _reference():
    return jbuild_model(jget_config("qwen3-8b").reduced(), system="sdrns",
                        rns_impl="interpret")


def _port(tree, prompts, system):
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system=system, device="cpu")
    eng = ServingEngine(model, from_jax_params(tree, cfg, "cpu"), batch=B,
                        s_max=S_MAX, page_size=PS, kv_format="rns8",
                        device="cpu")
    res = eng.generate({"tokens": prompts}, max_new=MAX_NEW)
    assert res.steps == MAX_NEW - 1
    return res


def test_prepared_sd_planes_bit_exact(tree):
    """The digit planes and scales the port prepares equal the reference's
    ``prepare_params`` under sdrns, every layer and the logits weight."""
    cfg = get_config("qwen3-8b").reduced()
    jp = _reference().prepare_params(jtu.tree_map(jnp.asarray, tree))
    tp = build_model(cfg, system="sdrns", device="cpu").prepare_params(
        from_jax_params(tree, cfg, "cpu"))
    pairs = [(tp["embed"]["logits_w"], jp["embed"]["logits_w"], None)]
    for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                         ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            for i, layer in enumerate(tp["layers"]):
                pairs.append((layer[group][name]["w"],
                              jp["layers"][group][name]["w"], i))
    for t, j, i in pairs:
        assert t.layout == j.layout == "sd"
        jp_, js = (j.planes, j.scale) if i is None else (j.planes[i],
                                                         j.scale[i])
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(js))


def test_sdrns_generate_matches_reference_model_steps(tree, prompts):
    jm = _reference()
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
                               cfg.hd, fmt="rns8")
        kv = jkv.scatter_prefill(kv, cache.k, cache.v, tab, PS)
        prefill_logits = np.asarray(logits, np.float32)
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
    tr = _port(tree, prompts, "sdrns")
    np.testing.assert_allclose(tr.prefill_logits, prefill_logits, rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(
        tr.tokens, np.asarray(jnp.concatenate(out, axis=1)))


def test_sdrns_serve_equals_rns_serve_bit_for_bit(tree, prompts):
    sd, rns = _port(tree, prompts, "sdrns"), _port(tree, prompts, "rns")
    np.testing.assert_array_equal(sd.prefill_logits, rns.prefill_logits)
    np.testing.assert_array_equal(sd.tokens, rns.tokens)


def test_serve_cli_runs_sdrns_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--reduced", "--system", "sdrns", "--kv-format", "rns8",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "system=sdrns kv=rns8 device=cpu" in res.stdout
