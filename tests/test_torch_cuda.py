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
from repro_torch.core.moduli import P21
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rns_matmul as rm
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics.attention import merge_decode_partials
from repro_torch.serving.engine import ServingEngine

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
