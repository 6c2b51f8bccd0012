"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built with nvcc at first use); without one they skip.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Shapes
here are small and ragged (edges that do not fill a tile, K segments as
strided views, g > 1, head_dim below a warp); ``chip_smoke.py`` covers the
main path's full-width shapes.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.core.moduli import P21, P21R2
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rns_matmul as rm
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics.attention import merge_decode_partials
from repro_torch.serving.engine import ServingEngine
from repro_torch.testing.faults import FaultSpec, inject_faults

pytestmark = pytest.mark.cuda

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("M,K,N", [(37, 200, 130), (5, 64, 96),
                                   (8, 4160, 300), (70, 129, 65)])
def test_rns_matmul_kernel_bit_exact(gen, M, K, N):
    a = torch.randint(-64, 65, (3, M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-64, 65, (3, K, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    for lo, hi in ((0, K), (K // 3, K)):      # whole, and a segment view
        out = rm.rns_matmul_cuda(a[:, :, lo:hi], b[:, lo:hi], P21.moduli)
        ref = rm.rns_matmul_ref(a[:, :, lo:hi], b[:, lo:hi], P21.moduli)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("B,S,H,Kv,hd,causal", [
    (2, 100, 4, 2, 16, True), (3, 65, 8, 2, 32, False),
    (1, 130, 4, 4, 128, True)])
def test_flash_attention_kernel_f32(gen, B, S, H, Kv, hd, causal):
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
    k = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
    v = torch.randn(B, S, Kv, hd, generator=gen, device="cuda")
    kv_len = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    out = fa.flash_attention_cuda(q, k, v, kv_len, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, kv_len, causal=causal)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fmt", ["bf16", "rns8", "rns4"])
@pytest.mark.parametrize("H,Kv,hd,q_dtype", [
    (4, 4, 16, torch.float32), (8, 2, 128, torch.bfloat16)])
def test_paged_decode_kernel(gen, fmt, H, Kv, hd, q_dtype):
    B, ps, n_pmax = 3, 8, 4
    f = kvp.KV_FORMATS[fmt]
    pool = kvp.make_paged_kv(1, 1 + B * n_pmax, ps, Kv, hd, fmt=f,
                             device="cuda")
    dense = torch.randn(2, 1, B, n_pmax * ps, Kv, hd, generator=gen,
                        device="cuda").bfloat16()
    tab = (1 + torch.randperm(B * n_pmax, generator=gen, device="cuda")
           ).reshape(B, n_pmax).to(torch.int32)
    kvp.scatter_prefill(pool, dense[0], dense[1], tab, ps)
    tab[2, 3] = 0                                   # a dump-page entry
    kv_len = torch.tensor([5, 32, 17], dtype=torch.int32, device="cuda")
    lay = kvp.layer_slice(pool, 0)
    if f.is_residue:
        args = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
                lay.k.scale, lay.v.scale, tab, kv_len, ps, f.pack)
    else:
        args = (lay.k, lay.v, None, None, tab, kv_len, ps, None)
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(q_dtype)
    out = merge_decode_partials(*fa.paged_decode_cuda(q, *args))
    ref = merge_decode_partials(*fa.paged_decode_ref(q, *args))
    # bf16 pages round p to bf16 on both sides; an exp one ulp apart can
    # round to neighbouring bf16 values
    tol = 2e-3 if fmt == "bf16" else 1e-4
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_reduced_checkpoint_card_matches_cpu(gen):
    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(CKPT)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=3,
                            s_max=19, page_size=8, kv_format="rns8",
                            device=dev)
        res[dev] = eng.generate({"tokens": prompts}, max_new=8)
    np.testing.assert_allclose(res["cuda"].prefill_logits,
                               res["cpu"].prefill_logits, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)


def test_rns_matmul_kernel_p21r2_bit_exact(gen):
    """Five channels, the witnesses 131 and 133 centered into int8."""
    a = torch.randint(-66, 67, (5, 9, 700), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-66, 67, (5, 700, 70), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    assert torch.equal(rm.rns_matmul_cuda(a, b, P21R2.moduli),
                       rm.rns_matmul_ref(a, b, P21R2.moduli))


@pytest.mark.parametrize("H,Kv,q_dtype", [
    (4, 4, torch.float32), (8, 2, torch.bfloat16), (16, 4, torch.bfloat16)])
def test_paged_decode_syndrome_kernel(gen, H, Kv, q_dtype):
    """The syndrome mode reads lane 0 and the witness lanes of an rns8r
    pool in place (strided); syn equals the plain version bit for bit on a
    clean pool and with planted faults, and the syndrome-free mode reads
    the same strided lane 0."""
    B, ps, n_pmax, hd = 3, 8, 4, 32
    f = kvp.KV_FORMATS["rns8r"]
    pool = kvp.make_paged_kv(1, 1 + B * n_pmax, ps, Kv, hd, fmt=f,
                             device="cuda")
    dense = torch.randn(2, 1, B, n_pmax * ps, Kv, hd, generator=gen,
                        device="cuda").bfloat16()
    tab = (1 + torch.randperm(B * n_pmax, generator=gen, device="cuda")
           ).reshape(B, n_pmax).to(torch.int32)
    kvp.scatter_prefill(pool, dense[0], dense[1], tab, ps)
    unnamed = int(tab[2, 3])
    tab[2, 3] = 0                                   # a dump-page entry
    kv_len = torch.tensor([5, 32, 17], dtype=torch.int32, device="cuda")
    lay = kvp.layer_slice(pool, 0)
    lane0 = (lay.k.planes.select(-3, 0), lay.v.planes.select(-3, 0),
             lay.k.scale, lay.v.scale, tab, kv_len, ps, f.pack)
    wit = (lay.k.planes.narrow(-3, 1, 2), lay.v.planes.narrow(-3, 1, 2),
           f.mset.redundant_moduli)
    assert not lane0[0].is_contiguous()
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(q_dtype)

    def check():
        out = fa.paged_decode_cuda(q, *lane0, *wit)
        ref = fa.paged_decode_ref(q, *lane0, *wit)
        torch.testing.assert_close(merge_decode_partials(*out[:3]),
                                   merge_decode_partials(*ref[:3]),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(out[3], ref[3])
        plain = fa.paged_decode_cuda(q, *lane0)
        torch.testing.assert_close(merge_decode_partials(*plain),
                                   merge_decode_partials(*out[:3]),
                                   rtol=0, atol=0)
        return out[3].sum(dim=(1, 2)).tolist()

    assert check() == [0, 0, 0]
    tab_h = tab.cpu()
    k, v = lay.k.planes, lay.v.planes
    k[int(tab_h[0, 0]), 1, 1, 0, 3] ^= 0x01    # witness, slot 0 row 1 < 5
    v[int(tab_h[1, 2]), 3, 0, Kv - 1, 7] ^= 0x10  # packed byte, row 19 < 32
    v[int(tab_h[1, 3]), 7, 2, 0, 0] ^= 0x02    # witness, row 31 < 32
    k[int(tab_h[0, 1]), 0, 0, 0, 0] ^= 0x01    # row 8 past kv_len 5
    k[unnamed, 0, 0, 0, 0] ^= 0x04             # a page no table names
    assert check() == [1, 2, 0]


def test_redundant_serving_card_matches_cpu(gen):
    """P21R2 weights, rns8r pages, policy="strict" on the reduced
    checkpoint: the card's tokens equal the CPU's with zero syndromes, and
    an injected packed-byte flip is repaired to the same tokens."""
    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(CKPT)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", rns_mset=P21R2, device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=3,
                            s_max=19, page_size=8, kv_format="rns8r",
                            device=dev, policy="strict")
        res[dev] = eng.generate({"tokens": prompts}, max_new=8)
        assert eng.stats.faults.syndromes == 0
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)
    fault = FaultSpec(kind="kv", which="k", channel=0, at=(0, 1, 0, 0, 0),
                      bit=0x20)
    model = build_model(cfg, system="rns", rns_mset=P21R2, device="cuda")
    eng = ServingEngine(model, from_jax_params(tree, cfg, "cuda"), batch=3,
                        s_max=19, page_size=8, kv_format="rns8r",
                        device="cuda", policy="strict")
    with inject_faults(eng, [fault], after_steps=3):
        out = eng.generate({"tokens": prompts}, max_new=8)
    np.testing.assert_array_equal(out.tokens, res["cpu"].tokens)
    f = eng.stats.faults
    assert (f.syndromes, f.corrected, f.recomputes) == (1, 1, 0)
