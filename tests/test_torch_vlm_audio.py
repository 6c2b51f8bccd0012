"""The vlm (pixtral-12b) and audio (whisper-small) families at their
reduced shapes against the JAX package.

Each reduced model has random weights from ``jax.random.PRNGKey(0)``,
carried into the port through ``convert.from_jax_params``; frames and
patches come from a numpy seed.  The reference runs its residue matmuls
through its exact ``ref`` backend and its attention through its Pallas
kernels in interpret mode, stepped model function by model function; the
port runs through its serving engine (pixtral on rns8 pages, whisper on the
dense cache).  Prefill logits must agree within ``LOGIT_TOL`` and greedy
tokens must be equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.models.attention import set_attn_impl
from repro.numerics import kv_pages as jkv
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.api import build_model
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.serving.engine import ServingEngine

LOGIT_TOL = 1e-4
B, PLEN, NEW, PS = 3, 6, 4, 8
S_ENC = 12                 # encoder frames of the reduced whisper
FAMILIES = ("whisper-small", "pixtral-12b")


def _narrow(cfg):
    """pixtral's attention width differs from d_model (32 x 128 = 4096
    against 5120); the reduced config has 4 x 16 = 64 = d_model, so the
    narrow variant cuts head_dim to 8: 32 against 64."""
    return dataclasses.replace(cfg, head_dim=8)


CASES = {
    # name: (arch, narrow, system, kv_format)
    "whisper-bns": ("whisper-small", False, "bns", None),
    "whisper-rns": ("whisper-small", False, "rns", None),
    "pixtral-rns8": ("pixtral-12b", False, "rns", "rns8"),
    "pixtral-narrow-rns8": ("pixtral-12b", True, "rns", "rns8"),
}


def _cfgs(arch, narrow):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if narrow:
        jcfg, tcfg = _narrow(jcfg), _narrow(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def trees():
    out = {}

    def get(arch, narrow=False):
        if (arch, narrow) not in out:
            jm = jbuild_model(_cfgs(arch, narrow)[0], system="bns")
            out[arch, narrow] = jtu.tree_map(
                np.asarray, jm.init(jax.random.PRNGKey(0)))
        return out[arch, narrow]

    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_config_copies_match_reference(arch):
    assert arch in ARCH_IDS
    ref = jget_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(ref.reduced())
    full = get_config("pixtral-12b")
    assert full.n_heads * full.hd == 4096 != full.d_model


@pytest.mark.parametrize("length,d", [(16, 64), (448, 768), (1500, 768),
                                      (5, 3), (1, 2)])
def test_sinusoidal_positions_match_reference(length, d):
    """Equal to the reference's up to the last ulps of its f32 ``exp`` and
    ``sin``/``cos`` (XLA's and PyTorch's CPU approximations differ by an
    ulp): a frequency one ulp apart moves the angle at position ``p`` by
    ``p`` ulps of the frequency, so the bound grows with the length."""
    from repro.models.layers import sinusoidal_positions as jsin
    from repro_torch.models.layers import sinusoidal_positions

    ref = np.asarray(jsin(length, d))
    got = sinusoidal_positions(length, d, device="cpu").numpy()
    assert got.shape == ref.shape == (length, 2 * (d // 2))
    tol = 2 * length * 2.0 ** -23 + 2.0 ** -22
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_gelu_mlp_matches_reference_tanh():
    """``gelu_mlp`` takes the tanh approximation (``jax.nn.gelu``'s
    default): on pre-activations where the tanh and the erf forms differ by
    well over the tolerance, the port equals the reference's."""
    from repro.models import mlp as jmlp
    from repro_torch.models import mlp as tmlp

    rng = np.random.default_rng(0)
    d, f = 16, 32
    params = {"w_up": {"w": rng.standard_normal((d, f)).astype(np.float32)},
              "w_down": {"w": (rng.standard_normal((f, d)) * 0.1).astype(
                  np.float32)}}
    x = (rng.standard_normal((4, 5, d)) * 0.8).astype(np.float32)
    ref = np.asarray(jmlp.gelu_mlp(jtu.tree_map(jnp.asarray, params),
                                   jnp.asarray(x),
                                   {"compute_dtype": jnp.float32}))
    tp = jtu.tree_map(torch.as_tensor, params)
    got = tmlp.gelu_mlp(tp, torch.as_tensor(x),
                        {"compute_dtype": torch.float32}).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    h = torch.as_tensor(x) @ tp["w_up"]["w"]
    gap = (torch.nn.functional.gelu(h, approximate="tanh")
           - torch.nn.functional.gelu(h)).abs().max()
    assert gap > 1e-4              # erf would be far outside the tolerance


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_params(trees, arch):
    cfg = get_config(arch).reduced()
    p = from_jax_params(trees(arch), cfg, "cpu")
    if cfg.is_encdec:
        assert len(p["enc_layers"]) == cfg.n_enc_layers
        assert len(p["dec_layers"]) == cfg.n_layers
        assert set(p["dec_layers"][0]) == {
            "self_norm", "self_attn", "cross_norm", "cross_attn",
            "mlp_norm", "mlp"}
        assert set(p["enc_layers"][0]["mlp"]) == {"w_up", "w_down"}
    else:
        assert len(p["layers"]) == cfg.n_layers
        assert set(p["layers"][0]["mlp"]) == {"w_gate", "w_up", "w_down"}
    assert all(t.dtype == torch.float32 for t in jtu.tree_leaves(p))
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(trees(arch), get_config(arch), "cpu")
    prepared = build_model(cfg, system="rns", device="cpu").prepare_params(p)
    # the audio family's logits stay a float product: no resident logits_w
    assert ("logits_w" in prepared["embed"]) == (not cfg.is_encdec)
    stack = prepared["enc_layers" if cfg.is_encdec else "layers"][0]
    assert isinstance(stack["mlp"]["w_up"]["w"], ResidueTensor)


def _inputs(jcfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, PLEN)).astype(np.int32)
    if jcfg.is_encdec:
        extra = (rng.standard_normal((B, S_ENC, jcfg.d_model)) * 0.1
                 ).astype(np.float32)
    else:
        extra = (rng.standard_normal((B, jcfg.n_img_tokens, jcfg.d_model))
                 * 0.1).astype(np.float32)
    return toks, extra


def _reference_steps(jcfg, tree, system, kv_format, toks, extra):
    """Prefill logits and greedy tokens from the reference's model functions
    stepped: the dense cache for the audio family, rns8 pages for vlm."""
    jm = jbuild_model(jcfg, system=system,
                      rns_impl="ref" if system == "rns" else None)
    jp = jm.prepare_params(jtu.tree_map(jnp.asarray, tree))
    prev = set_attn_impl("interpret")
    try:
        if jcfg.is_encdec:
            logits, cache = jm.prefill(jp, {"frames": jnp.asarray(extra),
                                            "tokens": jnp.asarray(toks)})
            plen = PLEN
        else:
            plen = PLEN + jcfg.n_img_tokens
            s_max = plen + NEW + 1
            logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                            "patches": jnp.asarray(extra)},
                                       s_max=s_max)
            n_pmax = -(-s_max // PS)
            tab = jnp.asarray((1 + np.arange(B * n_pmax)).reshape(
                B, n_pmax), jnp.int32)
            kv = jkv.make_paged_kv(jcfg.n_layers, 1 + B * n_pmax, PS,
                                   jcfg.n_kv, jcfg.hd, fmt=kv_format)
            kv = jkv.scatter_prefill(kv, cache.k, cache.v, tab, PS)
        first = np.asarray(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out = [tok]
        for i in range(NEW - 1):
            if jcfg.is_encdec:
                logits, cache = jm.decode(jp, tok, cache,
                                          jnp.int32(plen + i))
            else:
                logits, kv = jm.decode_paged(
                    jp, tok, kv, tab, jnp.full((B,), plen + i, jnp.int32),
                    page_size=PS)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(tok)
    finally:
        set_attn_impl(prev)
    return first, np.asarray(jnp.concatenate(out, axis=1))


def _port_generate(tcfg, tree, system, kv_format, toks, extra):
    model = build_model(tcfg, system=system, device="cpu")
    params = from_jax_params(tree, tcfg, "cpu")
    if tcfg.is_encdec:
        eng = ServingEngine(model, params, batch=B, s_max=S_ENC,
                            device="cpu")
        inputs = {"tokens": toks, "frames": torch.as_tensor(extra)}
    else:
        s_max = PLEN + tcfg.n_img_tokens + NEW + 1
        eng = ServingEngine(model, params, batch=B, s_max=s_max,
                            page_size=PS, kv_format=kv_format, device="cpu")
        inputs = {"tokens": toks, "patches": torch.as_tensor(extra)}
    assert eng.paged == (not tcfg.is_encdec)
    res = eng.generate(inputs, max_new=NEW)
    assert res.steps == NEW - 1
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_reference(trees, case):
    """Reduced whisper under bns and rns, reduced pixtral and its
    narrow-attention variant under rns on rns8 pages: the port's engine
    against the reference's model functions stepped."""
    arch, narrow, system, kv_format = CASES[case]
    jcfg, tcfg = _cfgs(arch, narrow)
    tree = trees(arch, narrow)
    toks, extra = _inputs(jcfg)
    jfirst, jtoks = _reference_steps(jcfg, tree, system, kv_format, toks,
                                     extra)
    res = _port_generate(tcfg, tree, system, kv_format, toks, extra)
    np.testing.assert_allclose(res.prefill_logits, jfirst, rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(res.tokens, jtoks)


def test_family_errors(trees):
    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, from_jax_params(trees(cfg.name), cfg, "cpu"),
                        batch=B, s_max=S_ENC, device="cpu")
    toks = np.zeros((B, PLEN), np.int32)
    with pytest.raises(ValueError, match="frames"):
        eng.generate({"tokens": toks}, max_new=2)
    frames = torch.zeros(B, S_ENC, cfg.d_model)
    with pytest.raises(ValueError, match="dec_len"):
        eng.generate({"tokens": toks, "frames": frames},
                     max_new=cfg.dec_len)
    assert model.decode_paged is None and model.verify_paged is None
    pix = get_config("pixtral-12b").reduced()
    pm = build_model(pix, device="cpu")
    peng = ServingEngine(pm, from_jax_params(trees(pix.name), pix, "cpu"),
                         batch=B, s_max=PLEN + pix.n_img_tokens + NEW,
                         page_size=PS, device="cpu", spec="ngram:2")
    with pytest.raises(ValueError, match="token prompts"):
        peng.generate({"tokens": toks, "patches": torch.zeros(
            B, pix.n_img_tokens, pix.d_model)}, max_new=NEW)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--reduced", "--system", "rns",
                       "--kv-format", "rns8", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}" in out and "seq0" in out
