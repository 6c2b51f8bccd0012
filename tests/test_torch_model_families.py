"""The model families the port serves beside qwen3-8b and zamba2-7b: the
dense yi-6b, phi3-medium-14b and granite-20b, the ssm mamba2-780m and the
moe moonshot-v1-16b-a3b and grok-1-314b, at their reduced shapes against
the JAX package.

Each reduced model has random weights from ``jax.random.PRNGKey(0)``,
carried into the port as numpy through ``convert.from_jax_params``, and
runs under ``system="rns"`` in both packages: the reference's residue
matmuls through its exact ``ref`` backend, its attention through its
Pallas kernels in interpret mode (its ``ref`` decode does not round the
softmax weights to the cache dtype as its kernel and the port's do).
Prefill logits must agree within ``LOGIT_TOL`` (f32 compute, float sums in
another order); greedy tokens, each model's functions stepped over the
dense cache from its own argmax, must be equal.  Reduced granite is the
first g > 1 case (H 4, Kv 1) held against the reference end to end.

grok-1-314b stores its parameters in bf16, so its embedding rows put the
first layer's int4 activation codes on exact rounding ties (7 x / amax =
k + 1/2), where the one-ulp difference between XLA's and PyTorch's
RMSNorm (their mean and rsqrt round differently) decides the code.  Its
end-to-end parity is held under ``bns`` on any prompt, and under ``rns`` on
prompts drawn from the rows with no such tie;
``test_grok_codes_differ_only_at_ties`` pins where the codes may differ
and shows that the norm, not the quantizer, picks the side.
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.models.api import build_model
from repro_torch.models.ssm import SsmCache
from repro_torch.numerics.tensor import ResidueTensor

from torch_threads import one_thread  # noqa: F401

LOGIT_TOL = 1e-4
B, PLEN, NEW = 3, 8, 3          # PLEN: one SSM chunk of the reduced mamba2
FAMILIES = ["yi-6b", "phi3-medium-14b", "granite-20b", "mamba2-780m",
            "moonshot-v1-16b-a3b", "grok-1-314b"]


@pytest.fixture(scope="module")
def trees():
    """Reduced float trees from the reference's init, as numpy."""
    out = {}

    def get(arch):
        if arch not in out:
            jm = jbuild_model(jget_config(arch).reduced(), system="bns")
            out[arch] = jtu.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0)))
        return out[arch]

    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match_reference(arch):
    """Every field of every ported config, at full size and reduced."""
    ref = jget_config(arch)
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(ref.reduced())


def test_refused_families():
    """Every family of the reference is served (the audio one by
    ``models/encdec.py``); a family or an MLP the reference does not define
    is refused, and the decoder-only LM refuses the audio family."""
    from repro_torch.models import transformer

    base = get_config("yi-6b").reduced()
    for kw in (dict(family="rwkv"), dict(mlp_type="relu")):
        model = build_model(dataclasses.replace(base, **kw), device="cpu")
        with pytest.raises(ValueError, match="serves"):
            model.init(0)
    with pytest.raises(ValueError, match="encdec"):
        transformer.init_lm(torch.Generator(), get_config(
            "whisper-small").reduced(), device="cpu")
    for kw in (dict(family="vlm"), dict(mlp_type="gelu")):
        build_model(dataclasses.replace(base, **kw), device="cpu").init(0)


def test_moe_ignores_mlp_type(trees):
    """moe experts are SwiGLU whatever ``mlp_type`` says, in the reference
    and in the port: a moe config with ``mlp_type="gelu"`` gives the
    reference the same parameters as the swiglu one, and both packages the
    same prefill logits, the port's equal to its swiglu config's."""
    arch = "moonshot-v1-16b-a3b"
    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, mlp_type="gelu")
    jm = jbuild_model(dataclasses.replace(jget_config(arch).reduced(),
                                          mlp_type="gelu"), system="bns")
    jtree = jtu.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    assert jtu.tree_structure(jtree) == jtu.tree_structure(trees(arch))
    for a, b in zip(jtu.tree_leaves(jtree), jtu.tree_leaves(trees(arch))):
        np.testing.assert_array_equal(a, b)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PLEN)).astype(np.int32)
    logits = []
    for c in (cfg, base):
        tm = build_model(c, system="bns", device="cpu")
        tp = tm.prepare_params(from_jax_params(jtree, c, "cpu"))
        logits.append(tm.prefill(tp, toks, s_max=PLEN + 1)[0].numpy())
    np.testing.assert_array_equal(logits[0], logits[1])
    prev = set_attn_impl("interpret")
    try:
        jl, _ = jm.prefill(jm.prepare_params(jtu.tree_map(jnp.asarray,
                                                          jtree)),
                           {"tokens": jnp.asarray(toks)}, s_max=PLEN + 1)
    finally:
        set_attn_impl(prev)
    np.testing.assert_allclose(logits[0], np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_params(trees, arch):
    cfg = get_config(arch).reduced()
    p = from_jax_params(trees(arch), cfg, "cpu")
    assert len(p["layers"]) == cfg.n_layers
    lay = p["layers"][0]
    if cfg.family == "ssm":
        assert set(lay) == {"norm", "mamba"}
    elif cfg.family == "moe":
        assert set(lay) == {"attn_norm", "attn", "mlp_norm", "moe"}
        assert lay["moe"]["w_gate"].shape == (cfg.n_experts, cfg.d_model,
                                              cfg.d_ff)
        assert lay["moe"]["router"]["w"].shape == (cfg.d_model,
                                                   cfg.n_experts)
    else:
        assert set(lay) == {"attn_norm", "attn", "mlp_norm", "mlp"}
    # grok stores bf16 parameters: they come across as f32, exactly
    assert all(t.dtype == torch.float32 for t in jtu.tree_leaves(p))
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(trees(arch), get_config(arch), "cpu")


def test_prepare_params_skips_the_router(trees):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    model = build_model(cfg, system="rns", device="cpu")
    p = model.prepare_params(from_jax_params(trees(cfg.name), cfg, "cpu"))
    m = p["layers"][0]["moe"]
    assert isinstance(m["router"]["w"], torch.Tensor)
    for name in ("w_gate", "w_up", "w_down"):
        assert isinstance(m[name], ResidueTensor)
        assert m[name].stack_shape == (cfg.n_experts,)
    assert model.prepare_params(p)["layers"][0]["moe"]["w_up"] is m["w_up"]
    assert model.decode_paged is not None and model.verify_paged is not None


def _match_reference(trees, arch, system, toks):
    """Prefill logits of ``toks`` within LOGIT_TOL of the reference's;
    greedy tokens from both packages' model functions stepped equal."""
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jget_config(arch).reduced(), system=system,
                      rns_impl="ref" if system == "rns" else None)
    jp = jm.prepare_params(jtu.tree_map(jnp.asarray, trees(arch)))
    tm = build_model(cfg, system=system, device="cpu")
    tp = tm.prepare_params(from_jax_params(trees(arch), cfg, "cpu"))
    s_max = PLEN + NEW + 1
    prev = set_attn_impl("interpret")
    try:
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=s_max)
        tl, tc = tm.prefill(tp, toks, s_max=s_max)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_TOL)
        if cfg.family == "ssm":
            assert isinstance(tc, SsmCache)
        jt, tt = np.asarray(jnp.argmax(jl, -1)), tl.argmax(-1).numpy()
        jts, tts = [jt], [tt]
        for i in range(NEW - 1):
            jl, jc = jm.decode(jp, jnp.asarray(jt[:, None]), jc,
                               jnp.int32(PLEN + i))
            tl, tc = tm.decode(tp, tt[:, None], tc, PLEN + i)
            jt, tt = np.asarray(jnp.argmax(jl, -1)), tl.argmax(-1).numpy()
            jts.append(jt)
            tts.append(tt)
    finally:
        set_attn_impl(prev)
    np.testing.assert_array_equal(np.stack(tts), np.stack(jts))
    return np.stack(tts)


@pytest.mark.parametrize("arch,system", [
    ("yi-6b", "rns"), ("phi3-medium-14b", "rns"), ("granite-20b", "rns"),
    ("mamba2-780m", "rns"), ("moonshot-v1-16b-a3b", "rns"),
    ("grok-1-314b", "bns")])
def test_family_matches_reference(trees, arch, system):
    """Reduced prefill logits within LOGIT_TOL of the reference's; greedy
    tokens from both packages' model functions stepped equal."""
    toks = np.random.default_rng(0).integers(
        0, get_config(arch).reduced().vocab, (B, PLEN)).astype(np.int32)
    _match_reference(trees, arch, system, toks)


def _grok_ties(tree):
    """Where grok's bf16 embedding rows put the first layer's int4 codes
    on an exact rounding tie (7 x / amax = k + 1/2, in float64)."""
    x64 = np.asarray(tree["embed"]["table"]).astype(np.float64)
    exact = 7 * x64 / np.abs(x64).max(-1, keepdims=True)
    return np.abs(exact - np.floor(exact)) == 0.5


def test_grok_rns_matches_reference_off_ties(trees):
    """grok under ``rns`` end to end: prompts drawn from the vocabulary
    rows whose first-layer codes sit on no tie (``_grok_ties``), the prefill
    logits within LOGIT_TOL and the greedy tokens equal."""
    tree = trees("grok-1-314b")
    free = np.flatnonzero(~_grok_ties(tree).any(-1))
    assert 0 < free.size < tree["embed"]["table"].shape[0]
    toks = np.random.default_rng(0).choice(free, (B, PLEN)).astype(np.int32)
    _match_reference(trees, "grok-1-314b", "rns", toks)


def test_grok_codes_differ_only_at_ties(trees):
    """grok's bf16 embedding rows through the first RMSNorm and the int4
    activation quantizer in both packages: the codes agree everywhere but
    at exact rounding ties (``_grok_ties``).  Each package's quantizer fed
    the other's RMSNorm output gives that package's codes bit for bit, so
    the norm's last ulp, not the quantizer, picks the side of a tie.  The
    port's own rns serve of the reduced grok runs on every prompt."""
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro.quant.quant import quantize_symmetric as jquant
    from repro_torch.models.layers import rmsnorm
    from repro_torch.quant.quant import quantize_symmetric

    tree = trees("grok-1-314b")
    cfg = get_config("grok-1-314b").reduced()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, PLEN))
    x = np.asarray(tree["embed"]["table"]).astype(np.float32)[toks]
    scale = np.asarray(tree["layers"]["attn_norm"]["scale"][0]).astype(
        np.float32)
    assert not (scale - 1).any()            # the norm multiplies by one
    jn = np.array(jrmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    tn = rmsnorm({"scale": torch.from_numpy(scale)},
                 torch.from_numpy(x)).numpy()
    jq = np.asarray(jquant(jnp.asarray(jn), 4, axis=-1)[0])
    tq = quantize_symmetric(torch.from_numpy(tn), 4, axis=-1)[0].numpy()
    np.testing.assert_array_equal(
        quantize_symmetric(torch.from_numpy(jn), 4, axis=-1)[0].numpy(), jq)
    np.testing.assert_array_equal(
        np.asarray(jquant(jnp.asarray(tn), 4, axis=-1)[0]), tq)
    assert np.abs(tn - jn).max() <= np.spacing(np.abs(jn).max())
    differ = tq != jq
    assert differ.any()                     # the ties this test is about
    assert not (differ & ~_grok_ties(tree)[toks]).any()
    assert np.abs(tq - jq)[differ].max(initial=0) <= 1
    model = build_model(cfg, system="rns", device="cpu")
    params = model.prepare_params(from_jax_params(tree, cfg, "cpu"))
    logits, _ = model.prefill(params, toks, s_max=PLEN + 1)
    assert torch.isfinite(logits).all()


def test_init_cache_layouts():
    c = build_model(get_config("mamba2-780m").reduced(),
                    device="cpu").init_cache(2, 12)
    assert isinstance(c, SsmCache)
    assert c.state.shape == (2, 2, 8, 16, 16) and c.conv.shape == (2, 2, 3,
                                                                   160)
    cfg = get_config("granite-20b").reduced()
    assert (cfg.n_heads, cfg.n_kv) == (4, 1)
    c = build_model(cfg, device="cpu").init_cache(2, 12)
    assert c.k.shape == (2, 2, 12, 1, 16)
    assert build_model(get_config("mamba2-780m").reduced(),
                       device="cpu").decode_paged is None


@pytest.mark.parametrize("arch,kv", [("moonshot-v1-16b-a3b", "rns8"),
                                     ("mamba2-780m", "dense")])
def test_cli_serves_reduced(capsys, arch, kv):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--reduced", "--system", "rns",
                       "--kv-format", "rns8", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "8", "--max-new", "3"]) == 0
    assert f"{arch} system=rns kv={kv}" in capsys.readouterr().out
