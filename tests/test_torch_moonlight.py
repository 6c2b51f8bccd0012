"""Moonlight-16B-A3B (the port's ``MlaMoeConfig``: latent attention,
sigmoid-routed experts with shared experts, a leading dense layer, an
untied head) on the CPU at a tiny size, against the plain reference
``perfbench/reference/moonlight_mla_moe.py`` on seeded random weights
(the benchmark family ``perfbench/families/mla_moe.py`` makes both sides'
weights from one seed).

* the configuration resolves beside the reference's architectures;
* DeepSeek-V3's rotary pairing, against an explicit pairwise rotation;
* routing with a correction bias large enough to change choices;
* the dense layer 0 and the expert block with its shared experts;
* a padded admission: padded rows take no expert slot;
* prefill logits through ``ServingEngine.admit_prefill``, then 4 paged
  decode steps through the latent pages, against the reference;
* the expert layers' counters; B2's unequal widths (plain and meta) and
  the yardstick's split work; the ``serve_mla`` driver on a tiny cell.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config, is_mla
from repro_torch.kernels import flash_attn
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as kvp
from repro_torch.serving.engine import ServingEngine

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PERF = ROOT / "perfbench"
if str(PERF) not in sys.path:
    sys.path.insert(0, str(PERF))

from families import mla_moe as fam  # noqa: E402
from harness import main as bench  # noqa: E402
from reference import moonlight_mla_moe as ref  # noqa: E402
from yardstick import mla as yard_mla  # noqa: E402
from yardstick import work as yard_work  # noqa: E402

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=3, num_hidden_layers=3,
            vocab_size=512, initializer_range=0.1)
SEED = 2**33 + 17


def tiny_cfg(dtype="float32", cf=8.0, **kw) -> dict:
    """The benchmark's configuration at a tiny size (cf 8: no expert drops
    unless asked for)."""
    cfg = json.loads((PERF / "configs" / "moonlight-16b-a3b.json")
                     .read_text())
    cfg.update(TINY, torch_dtype=dtype, **kw)
    cfg["port"] = dict(cfg["port"], capacity_factor=cf)
    return cfg


def prec_of(cfg: dict) -> ref.Prec:
    return dataclasses.replace(ref.CONFIGURED,
                               dtype=getattr(torch, cfg["torch_dtype"]))


def program(cfg: dict, seed: int = SEED):
    model = fam.build(cfg, "cpu")
    return model, fam.params(model, cfg, seed, "cpu")


def reference(cfg: dict, seed: int = SEED) -> ref.ServedModel:
    p = prec_of(cfg)
    dev = torch.device("cpu")
    return ref.ServedModel(
        [ref.Served(fam.layer_leaves(cfg, seed, i, dev), cfg, p)
         for i in range(cfg["num_hidden_layers"])],
        fam.embed_table(cfg, seed, dev), fam.final_norm(cfg, seed, dev),
        fam.lm_head(cfg, seed, dev), p)


def _rel(a, b) -> float:
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float((a - b).abs().max() / b.abs().max())


# -- configuration -----------------------------------------------------------

def test_config_resolves_beside_the_reference_archs():
    cfg = get_config("moonlight-16b-a3b")
    assert is_mla(cfg) and "moonlight-16b-a3b" in PORT_ARCH_IDS
    assert "moonlight-16b-a3b" not in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == \
        (27, 2048, 16, 163840)
    assert (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim, cfg.hd) == (512, 128, 64, 128, 192)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.n_shared,
            cfg.first_dense, cfg.dense_d_ff) == (64, 6, 1408, 2, 1, 11264)
    assert cfg.routed_scale == 2.446 and not cfg.tie_embeddings
    assert tf.kv_dims(cfg) == (1, 512, 64)
    assert not is_mla(get_config("moonshot-v1-16b-a3b"))
    # the benchmark family's config from the published keys is the port's
    published = json.loads((PERF / "configs" / "moonlight-16b-a3b.json")
                           .read_text())
    assert fam.arch_config(published) == dataclasses.replace(
        cfg, moe_cf=1.25)


def test_refusals():
    cfg = get_config("moonlight-16b-a3b").reduced()
    model = build_model(cfg, system="rns", device="cpu")
    params = model.init(0)
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="training forward"):
        model.loss(params, {"tokens": tok, "labels": tok})
    _, cache = model.prefill(params, tok, s_max=8)
    with pytest.raises(ValueError, match="dense-cache decode"):
        model.decode(params, tok[:, :1], cache, 4)


# -- rotary pairing ----------------------------------------------------------

def test_rope_interleaved_is_deepseek_pairing():
    """Each pair (2i, 2i+1) turns by pos x theta^(-2i/d); the output holds
    the evens then the odds (the published layout), and the reference's
    rope agrees.  The half pairing is unchanged."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 3, 8, generator=g)
    pos = torch.arange(5)
    theta = 5e4
    got = layers.rope(x, pos, theta=theta, pairing="interleaved")
    i = torch.arange(4, dtype=torch.float32)
    ang = pos[:, None, None].float() * theta ** (-2 * i / 8)
    a, b = x[..., 0::2], x[..., 1::2]
    want = torch.cat([a * ang.cos() - b * ang.sin(),
                      a * ang.sin() + b * ang.cos()], dim=-1)
    # f32 sin/cos of the same angles, another order of the products
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    r = ref.rope(x[0], pos, theta, ref.Prec(dtype=torch.float32))
    assert torch.equal(got[0], r)
    half = layers.rope(x, pos, theta=theta)
    assert torch.equal(half, layers.rope(x, pos, theta=theta,
                                         pairing="half"))
    assert not torch.equal(half, got)
    with pytest.raises(ValueError, match="pairing"):
        layers.rope(x, pos, pairing="odd")


# -- routing, the dense layer, the expert block --------------------------------

def test_route_sigmoid_follows_the_correction_bias():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(16, 8, generator=g)
    x = torch.randn(40, 16, generator=g)
    bias = torch.zeros(8)
    bias[5] = 3.0             # past any score gap: expert 5 always chosen
    scores, gates, idx = moe.route_sigmoid(w, bias, x, 3, 2.5)
    r_idx, r_gates = ref.route(w, bias, x, 3, 2.5)
    assert torch.equal(idx, r_idx) and torch.equal(gates, r_gates)
    assert bool((idx == 5).any(dim=1).all())
    _, _, plain = moe.route_sigmoid(w, torch.zeros(8), x, 3, 2.5)
    assert not torch.equal(idx, plain)       # a bias-blind router fails
    # the gates are the chosen scores (not score + bias), normalised, scaled
    chosen = torch.sigmoid(x.double() @ w.double()).float().gather(1, idx)
    torch.testing.assert_close(gates, chosen / chosen.sum(1, keepdim=True)
                               * 2.5, rtol=1e-6, atol=0)


def test_dense_layer_and_expert_block_with_shared_experts():
    """Layer 0's SwiGLU and an expert layer's routed + shared output equal
    the reference's stages bit for bit (the same f32 operations)."""
    cfg = tiny_cfg()
    acfg = fam.arch_config(cfg)
    model, params = program(cfg)
    dkw = {"system": "rns", "bits": 4, "compute_dtype": torch.float32}
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 12, 64, generator=g)
    p = prec_of(cfg)
    L0 = ref.Served(fam.layer_leaves(cfg, SEED, 0, "cpu"), cfg, p)
    y0 = tf._mlp_block(params["layers"][0], x, acfg, dkw)
    assert torch.equal(y0[0], L0.mlp(x[0]))
    L1 = ref.Served(fam.layer_leaves(cfg, SEED, 1, "cpu"), cfg, p)
    y1 = tf._mlp_block(params["layers"][1], x, acfg, dkw)
    idx, gates = L1.route(x[0])
    keep = torch.ones_like(idx, dtype=torch.bool)
    assert torch.equal(y1[0], L1.moe_rows(x[0], idx, gates, keep))
    # without its shared experts the block is another function
    lp = dict(params["layers"][1])
    lp["moe"] = {k: v for k, v in lp["moe"].items() if k != "shared"}
    assert not torch.equal(tf._mlp_block(lp, x, acfg, dkw), y1)


def test_padded_rows_take_no_expert_slot():
    """A right-padded batch routes its real rows as the unpadded prompts
    laid end to end: the same capacity and placement, so the same outputs;
    counting the padding instead drops or moves real tokens' slots."""
    cfg = tiny_cfg(cf=1.0)
    acfg = fam.arch_config(cfg)
    _, params = program(cfg)
    mp = params["layers"][1]["moe"]
    dkw = {"system": "rns", "bits": 4, "compute_dtype": torch.float32}
    kw = dict(n_experts=8, top_k=3, capacity_factor=acfg.moe_cf,
              dense_kw=dkw, routed_scale=2.446)
    g = torch.Generator().manual_seed(3)
    lens = [13, 5]
    rows = [torch.randn(n, 64, generator=g) for n in lens]
    padded = torch.zeros(2, 13, 64)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    padded[1, 5:] = torch.randn(8, 64, generator=g)   # padding is junk
    valid = torch.arange(13)[None, :] < torch.tensor(lens)[:, None]
    got = moe.moe(mp, padded, valid=valid, n_tokens=sum(lens), **kw)
    want = moe.moe(mp, torch.cat(rows)[None], **kw)[0]
    assert torch.equal(torch.cat([got[0], got[1, :5]]), want)
    blind = moe.moe(mp, padded, **kw)
    assert not torch.equal(torch.cat([blind[0], blind[1, :5]]), want)
    with pytest.raises(ValueError, match="n_tokens"):
        moe.moe(mp, padded, valid=valid, **kw)


# -- prefill and decode through the engine ---------------------------------

@pytest.mark.parametrize("kv_format", ["rns8", "bf16"])
def test_prefill_then_paged_decode_match_reference(kv_format):
    """Two ragged prompts admitted together (one right-padded prefill, the
    latent rows scattered into rns8 pages, or into pages of the cache
    dtype), then 4 greedy decode steps
    through ``decode_paged``, against the reference's prefill and its
    decode steps, which read every row's latent as its page holds it.  In
    f32 (compute and cache) the two differ only by the attention's order
    of summation (the program's plain B2 against the reference's einsum):
    1e-4 of the largest logit, as the other families' prefill tests hold
    the reference's logits.  A tiny random int4 model is chaotic: a flipped
    int4 code, or the cache rounded to bf16 before its pages, moves the
    logits by tenths of the largest (0.6 read here), far past it."""
    cfg = tiny_cfg()
    model, params = program(cfg)
    eng = ServingEngine(model, params, batch=2, s_max=32, page_size=8,
                        kv_format=kv_format, device="cpu",
                        cache_dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = {0: rng.integers(0, 512, 11), 1: rng.integers(0, 512, 6)}
    out = eng.admit_prefill(prompts, {s: 32 for s in prompts})
    r = reference(cfg)
    want = r.prefill([torch.as_tensor(prompts[s]) for s in (0, 1)])
    got = torch.stack([torch.as_tensor(out[s][0]) for s in (0, 1)])
    assert _rel(got, want) < 1e-4
    tabs = torch.as_tensor(np.stack([eng.pool.tab_row(out[s][1].pages,
                                                      eng.n_pmax)
                                     for s in (0, 1)]))
    tok = got.argmax(-1)[:, None]
    pos = torch.tensor([11, 6], dtype=torch.int32)
    for _ in range(4):
        logits, _ = model.decode_paged(eng.params, tok, eng.pool.kv, tabs,
                                       pos, page_size=8,
                                       cache_dtype=torch.float32)
        want = r.decode(tok[:, 0], paged=kv_format == "rns8")
        assert _rel(logits, want) < 1e-4
        tok, pos = logits.argmax(-1)[:, None], pos + 1


def test_served_arithmetic_converges_to_the_published_float_model():
    """The reference's served stages against its published model in f32
    (``forward_f32``: no codes, dropless): the gap is the codes' rounding,
    so it shrinks about 4x for every 2 bits of the weight and activation
    codes; at 8 bits the logits are within 8 % of the largest (4.0 % read
    here; at int4 a tiny random model reads 57 %)."""
    cfg = tiny_cfg()
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, 512, 9))
    leaves = [fam.layer_leaves(cfg, SEED, i, "cpu") for i in range(3)]
    table = fam.embed_table(cfg, SEED, "cpu")
    head = fam.lm_head(cfg, SEED, "cpu")
    f32 = ref.forward_f32(leaves, cfg, table, torch.ones(64), head,
                          tokens)[-1]
    gaps = []
    for bits in (4, 6, 8):
        p = ref.Prec(bits=bits, dtype=torch.float32)
        r = ref.ServedModel([ref.Served(w, cfg, p) for w in leaves], table,
                            torch.ones(64), head, p)
        gaps.append(_rel(r.prefill([tokens])[0], f32))
    assert gaps[0] > gaps[1] > gaps[2] and gaps[2] < 0.08, gaps


# -- counters ----------------------------------------------------------------

def test_moe_counters_fold_device_counts():
    """Under the profiler an admission counts each expert layer's real
    (token, slot) pairs, its drops and its E x C rows; the drops equal the
    reference's placement over the admission's real rows.  Off, nothing is
    counted."""
    cfg = tiny_cfg(cf=1.0)
    model, params = program(cfg)
    eng = ServingEngine(model, params, batch=2, s_max=32, page_size=8,
                        kv_format="rns8", device="cpu")
    rng = np.random.default_rng(6)
    prompts = {0: rng.integers(0, 512, 14), 1: rng.integers(0, 512, 9)}
    seen = []           # each expert layer's real input rows, call order
    orig = tf._mlp_block

    def grab(lp, x, *a, **kw):
        if "moe" in lp:
            seen.append(torch.cat([x[0, :14], x[1, :9]]))
        return orig(lp, x, *a, **kw)

    tracing.snapshot()
    tf._mlp_block = grab
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            eng.admit_prefill(prompts, {s: 32 for s in prompts})
    finally:
        tf._mlp_block = orig
    counters = tracing.snapshot()["counters"]
    n, E, K = 23, 8, 3
    C = ref.capacity(n, E, K, 1.0)
    assert counters["moe.slots"] == 2 * n * K
    assert counters["moe.capacity_rows"] == 2 * E * C
    p = prec_of(cfg)
    drops = 0
    for li, x in zip((1, 2), seen):
        L = ref.Served(fam.layer_leaves(cfg, SEED, li, "cpu"), cfg, p)
        idx, _ = L.route(x)
        drops += int((~ref.place(idx, E, C)).sum())
    assert drops > 0 and counters["moe.dropped"] == drops
    eng.pool.reset()
    eng.admit_prefill(prompts, {s: 32 for s in prompts})
    assert tracing.snapshot()["counters"] == counters    # off: unchanged


def test_device_counts_are_summed_at_snapshot():
    tracing.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        tracing.count("moe.dropped", torch.tensor(3))
        tracing.count("moe.dropped", torch.tensor(4, dtype=torch.int32))
        tracing.count("moe.dropped", 5)
    assert not tracing.enabled()
    assert tracing.snapshot()["counters"]["moe.dropped"] == 12


# -- B2 at unequal widths, pages of two widths, the yardstick -----------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_unequal_widths(causal):
    """The plain B2 with q and k of 24 and v of 16 against softmax attention
    written out in f64 (f32 sums: 1e-5), and its meta shape."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 9, 4, 24, generator=g)
    k = torch.randn(2, 11, 2, 24, generator=g)
    v = torch.randn(2, 11, 2, 16, generator=g)
    kv_len = torch.tensor([11, 7], dtype=torch.int32)
    out = flash_attn.flash_attention_ref(q, k, v, kv_len, causal=causal)
    assert out.shape == (2, 9, 4, 16)
    s = torch.einsum("bqhd,bthd->bhqt", q.double(),
                     k.double().repeat_interleave(2, dim=2)) / 24 ** 0.5
    t = torch.arange(11)
    mask = t[None, None, None, :] < kv_len[:, None, None, None]
    if causal:
        mask = mask & (t[None, :] <= torch.arange(9)[:, None])
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    want = torch.einsum("bhqt,bthd->bqhd", p,
                        v.double().repeat_interleave(2, dim=2))
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    meta = flash_attn.flash_attention_meta(
        *(torch.empty(t_.shape, device="meta") for t_ in (q, k, v)))
    assert meta.shape == (2, 9, 4, 16)
    big = [torch.empty(8, 2048, 16, d, dtype=torch.bfloat16, device="meta")
           for d in (192, 192, 128)]
    assert flash_attn.flash_attention_meta(*big).shape == (8, 2048, 16, 128)


def test_pages_hold_two_widths():
    kv = kvp.make_paged_kv(2, 5, 4, 1, 32, fmt="rns8", device="cpu",
                           v_head_dim=8)
    assert kv.k.planes.shape[-1] == 32 and kv.v.planes.shape[-1] == 8
    assert kvp.bytes_per_token("rns8", 1, 32, v_head_dim=8) == \
        (32 + 4) + (8 + 4)
    assert kvp.bytes_per_token("rns8", 8, 128) == \
        kvp.bytes_per_token("rns8", 8, 128, v_head_dim=128)


@pytest.mark.parametrize("causal", [True, False])
def test_split_work_equals_attention_work_at_equal_widths(causal):
    lens = [300, 2048, 17]
    a = yard_work.attention_work(3, 2048, 16, 4, 128, lens, causal=causal,
                                 esz=2, kind="bf16", with_len=True)
    b = yard_mla.attention_work_split(3, 2048, 16, 4, 128, 128, lens,
                                      causal=causal, esz=2, kind="bf16",
                                      with_len=True)
    assert a == b
    q = torch.empty(2, 64, 16, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(2, 64, 16, 128, dtype=torch.bfloat16, device="meta")
    w = yard_mla.flash_attention_split_cost(q, q, v, causal=causal)
    pairs = 16 * 2 * (64 * 65 // 2 if causal else 64 * 64)
    assert w.ops == 2 * (192 + 128) * pairs
    assert w.bytes == 2 * (2 * 64 * 16 * 320 + 2 * 64 * 16 * 320)


# -- the benchmark's driver on a tiny cell ------------------------------------

def _tiny_cell(cf: float = 1.25) -> bench.Cell:
    cell = bench.load_cell("moonlight-16b-a3b.prefill")
    cell.config.update(TINY)
    cell.config["port"] = dict(cell.config["port"], capacity_factor=cf)
    cell.mix.update(job_size=16, strata=4,
                    prompt={"dist": "loguniform", "lo": 8, "hi": 64})
    wl = cell.workload
    wl.update(slots=4, warm=dict(wl["warm"], requests=4),
              check=dict(wl["check"], admission=1))
    return cell


def test_serve_mla_tiny_cell_is_correct():
    """The cell's driver end to end on the CPU (bf16 compute, capacity
    factor 1.25, so slots are dropped): every stage the check copies equals
    the reference's run from the program's input, the placement included;
    the control one precision step below fails; a traced run reads every
    new metric."""
    cell = _tiny_cell()
    drv = bench.driver(cell)
    keep: dict = {}
    run = drv.run(cell, seed=2**40 + 3, seconds=1.5, trace=False,
                  device="cpu", t_start=0.0, keep=keep)
    assert run.correct, run.numbers
    assert all(v == 0.0 for v in run.numbers.values()), run.numbers
    assert set(run.numbers) == set(drv.NUMBERS)
    ctl = drv.control(cell, 2**40 + 3, torch.device("cpu"),
                      keep["captures"])
    assert ctl["route_diff"] > 0
    assert any(ctl[k] > cell.workload["limits"][k] for k in ctl)
    run = drv.run(cell, seed=7, seconds=1.5, trace=True, device="cpu",
                  t_start=0.0)
    res = bench.result_line(cell, run, True, {"platform": "cpu"})
    for name in ("moe.dispatch_share.prefill", "moe.drop_share.prefill",
                 "moe.slack_share.prefill", "attn.latent_share.prefill",
                 "engine.pad_share.prefill", "numerics.encode_share.prefill"):
        assert res["metrics"][name]["value"] is not None, name
    assert 0 < res["metrics"]["moe.slack_share.prefill"]["value"] < 100


def test_cli_serves_reduced_moonlight():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "moonlight-16b-a3b", "--reduced", "--system", "rns", "--kv-format",
         "rns8", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve] moonlight-16b-a3b system=rns kv=rns8" in out.stdout


def test_serve_mla_loads_no_forbidden_module():
    """A tiny run of the cell's driver in a fresh process loads neither JAX
    nor the JAX package (the benchmark's guard, top-level names whole)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import test_torch_moonlight as t\n"
        "from harness import main\n"
        "c = t._tiny_cell()\n"
        "main.driver(c).run(c, seed=5, seconds=0.3, trace=False, "
        "device='cpu', t_start=0.0)\n"
        "print(main.forbidden_modules())\n" % (
            str(PERF), str(ROOT / "src"), str(ROOT / "tests")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
