"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built with nvcc at first use); without one they skip.  Run them on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Shapes
here are small and ragged (edges that do not fill a tile, K segments as
strided views, g > 1, head_dim below a warp); ``chip_smoke.py`` covers the
main path's full-width shapes.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.core.moduli import P21, P21R2
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rns_matmul as rm
from repro_torch.kernels import sd_add as sda
from repro_torch.kernels import sdrns_matmul as sdm
from repro_torch.models.api import build_model
from repro_torch.numerics import kv_pages as kvp
from repro_torch.numerics.attention import merge_decode_partials
from repro_torch.serving.engine import ServingEngine
from repro_torch.testing.faults import FaultSpec, inject_faults

from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("M,K,N", [
    (37, 200, 130), (5, 64, 96), (8, 4160, 300), (70, 129, 65),
    # the decode schedule (M <= 16) and the prefill's, around the threshold
    (1, 4096, 1024), (2, 4096, 1024), (15, 640, 200), (16, 640, 200),
    (17, 640, 200), (8, 129, 65), (16, 12288, 256), (8, 12288, 4096),
    (8, 512, 14576), (40, 256, 14576), (300, 1000, 520)])
def test_rns_matmul_kernel_bit_exact(gen, M, K, N):
    """Both schedules at ragged shapes: K split across blocks (K 4096 at N
    1024, K 12288), N 14576 (zamba2's in_proj), M 1-17 around the decode
    threshold; each whole and as a K segment view at an odd offset."""
    a = torch.randint(-64, 65, (3, M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-64, 65, (3, K, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    for lo, hi in ((0, K), (K // 3, K)):      # whole, and a segment view
        out = rm.rns_matmul_cuda(a[:, :, lo:hi], b[:, lo:hi], P21.moduli)
        ref = rm.rns_matmul_ref(a[:, :, lo:hi], b[:, lo:hi], P21.moduli)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("M", [2, 8, 16, 17, 2048])
@pytest.mark.parametrize("lo", [0, 128, 37])
def test_rns_matmul_kernel_extremes_and_views(gen, M, lo):
    """P21R2's five channels with operands at the int8 extremes (-128, 127)
    and the widest modulus's (+-66), the largest exact sums; K segments at
    a 128-aligned offset (16-byte loads) and an odd one (byte loads), as
    ``rns_run`` passes them.  The decode workspace is zero after each call
    (the last block of each tile clears it)."""
    K, N = 1408, 272
    vals = torch.tensor([-128, 127, -66, 66], dtype=torch.int8,
                        device="cuda")
    a = vals[torch.randint(0, 4, (5, M, K), generator=gen, device="cuda")]
    b = vals[torch.randint(0, 4, (5, K, N), generator=gen, device="cuda")]
    a[:, 0] = -128
    b[:, :, 0] = -128
    av, bv = a[:, :, lo:lo + 1024], b[:, lo:lo + 1024]
    assert torch.equal(rm.rns_matmul_cuda(av, bv, P21R2.moduli),
                       rm.rns_matmul_ref(av, bv, P21R2.moduli))
    torch.cuda.synchronize()
    assert all(int(ws.count_nonzero()) == 0 for ws in rm._workspaces.values())


def test_rns_matmul_kernel_repeated_decode_calls(gen):
    """Calls of several decode shapes in a row share one workspace: each
    leaves it zero for the next, so repeated calls give the same residues."""
    shapes = [(8, 4096, 1024), (8, 12288, 4096), (3, 700, 130),
              (16, 4096, 1024)]
    ops = []
    for M, K, N in shapes:
        a = torch.randint(-64, 65, (3, M, K), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-64, 65, (3, K, N), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        ops.append((a, b, rm.rns_matmul_ref(a, b, P21.moduli)))
    for _ in range(3):
        for a, b, ref in ops:
            assert torch.equal(rm.rns_matmul_cuda(a, b, P21.moduli), ref)


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


@pytest.mark.parametrize("B,Sq,T,H,Kv,hd,causal", [
    (2, 200, 200, 8, 2, 128, True), (2, 200, 200, 8, 2, 128, False),
    (3, 100, 100, 4, 4, 112, True), (2, 65, 150, 8, 8, 112, False),
    (3, 70, 70, 8, 2, 16, True), (2, 130, 130, 4, 1, 16, False),
    (1, 64, 64, 32, 8, 128, True)])
def test_flash_attention_kernel_bf16(gen, B, Sq, T, H, Kv, hd, causal):
    """B2's tensor-core route against its plain version at the reference's
    bf16 tolerance: S not a multiple of the 64-row tiles, kv_len < T (row
    0 inside the first tile), Sq != T, g = 1 and 4, head_dim 16, 112 and
    128.  Garbage past kv_len must not reach the output."""
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    kv_len = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = 7
    tail = torch.arange(T, device="cuda")[None, :] >= kv_len[:, None]
    k[tail] = float("nan")
    v[tail] = float("inf")
    out = fa.flash_attention_cuda(q, k, v, kv_len, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, kv_len, causal=causal)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("hd", [8, 24, 136])
def test_flash_attention_kernel_bf16_rejects_head_dim(gen, hd):
    """The tensor-core route takes head_dim a multiple of 16 up to 128; it
    raises for any other bf16 head_dim (no fallback to the f32 body)."""
    q = torch.randn(1, 8, 2, hd, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, q, q, causal=True)


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


def _digits(gen, *shape):
    return torch.randint(-1, 2, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("M,K,N,n", [
    (3, 129, 40, 7), (33, 64, 40, 7), (8, 300, 130, 5), (1, 1, 7, 7),
    (20, 1000, 33, 7), (9, 2, 300, 7),
    # around the 64-leaf K chunk, every B7 row count, N past a column tile
    (1, 63, 40, 7), (2, 64, 24, 7), (4, 65, 130, 7), (5, 127, 33, 5),
    (6, 128, 9, 7), (7, 129, 1030, 7), (2, 200, 3, 5),
    # the longest K of the serves (down), and B6 past 32 rows
    (8, 12288, 24, 7), (33, 200, 40, 7), (33, 4096, 12, 5)])
def test_sdrns_matmul_kernels_digit_exact(gen, M, K, N, n):
    """B6 (and B7 where M <= 8) give the plain version's digit vectors on
    random digits, whole and on a K segment view (offset K // 3, off the
    64-leaf chunk grid except at K 12288); ragged K exercises the zero
    leaves of the chunk and join trees, N below one column tile (512) a
    partial tile."""
    a = _digits(gen, 3, M, K, n)
    b = _digits(gen, 3, K, N, n)
    ws = (1, 0, -1)
    for lo, hi in ((0, K), (K // 3, K)):
        av, bv = a[:, :, lo:hi], b[:, lo:hi]
        ref = sdm.sdrns_matmul_ref(av, bv, ws)
        assert torch.equal(sdm.sdrns_matmul_cuda(av, bv, ws), ref)
        if M <= sdm.MATVEC_MAX_M:
            assert torch.equal(sdm.sdrns_matvec_cuda(av, bv, ws), ref)


def test_sdrns_matmul_kernel_rows_past_the_grid(gen):
    """B6 at M 65541 (VGG-16's convs are M 65536 at batch 64): the rows run
    in passes that fit the grid's 65535 limit; the digits of the rows
    around the pass boundary and the last ones equal the plain version's."""
    M, K, N = 65541, 70, 12
    a = _digits(gen, 3, M, K, 7)
    b = _digits(gen, 3, K, N, 7)
    ws = (1, 0, -1)
    out = sdm.sdrns_matmul_cuda(a, b, ws)
    for lo, hi in ((0, 8), (65524, 65541)):
        assert torch.equal(out[:, lo:hi],
                           sdm.sdrns_matmul_ref(a[:, lo:hi], b, ws))


@pytest.mark.parametrize("n", [1, 5, 7, 16])
@pytest.mark.parametrize("kind", ["pow2m1", "pow2", "pow2p1", "plain"])
def test_sd_add_kernel_bit_exact(gen, n, kind):
    x = _digits(gen, 7, 300, n)
    y = _digits(gen, 7, 300, n)
    assert torch.equal(sda.sd_add_cuda(x, y, kind), sda.sd_add_ref(x, y, kind))


@pytest.mark.parametrize("n", range(1, 17))
def test_sd_add_kernel_offsets_and_tiles(gen, n):
    """B8 in every kind on views at storage offsets 0, 1, 5 and 13 (bases
    off 16- and 4-byte alignment), vector counts around the 1024-vector
    tile and past the grid."""
    for B in (1, 1023, 1025, 3 * 1024 + 7, 600_001):
        for off in (0, 1, 5, 13):
            flat = _digits(gen, 2, B * n + off + 1)
            x = flat[0, off:off + B * n].view(B, n)
            y = flat[1, off + 1:off + 1 + B * n].view(B, n)
            assert x.storage_offset() == off
            for kind in sda.KINDS:
                assert torch.equal(sda.sd_add_cuda(x, y, kind),
                                   sda.sd_add_ref(x, y, kind)), (B, off, kind)


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("K", [4096, 12288])
def test_rns_matmul_kernel_p16_segments(gen, M, K):
    """B1 on P16 = (31, 32, 33) at the rns drafter's 3 bits: each K segment
    ``rns_run`` cuts (3 at K 4096, 7 at K 12288; views at offsets of
    1408 / 1792 terms) against its plain version, operands over 32's
    centred range (+16 included), on the decode schedule (M 8) and the
    prefill tile (M 40); and ``rns_run`` on the card equals it on the
    CPU."""
    from repro_torch.core.moduli import P16
    from repro_torch.numerics import runners

    a = torch.randint(-16, 17, (3, M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-16, 17, (3, K, 300), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    segs = runners.segment_count(K, 3, 3, P16)
    seg_len = -(-(-(-K // segs)) // 128) * 128
    assert -(-K // seg_len) == (3 if K == 4096 else 7)
    for lo in range(0, K, seg_len):
        av, bv = a[:, :, lo:lo + seg_len], b[:, lo:lo + seg_len]
        assert torch.equal(rm.rns_matmul_cuda(av, bv, P16.moduli),
                           rm.rns_matmul_ref(av, bv, P16.moduli))
    x = torch.randint(-3, 4, (M, K), generator=gen, device="cuda",
                      dtype=torch.int32)
    w = torch.randint(-3, 4, (K, 300), generator=gen, device="cuda",
                      dtype=torch.int32)
    planes = runners.encode_rns_planes(w, P16)
    out = runners.rns_run(x, planes, mset=P16, max_abs_a=3, max_abs_b=3)
    assert torch.equal(out.cpu(), x.cpu().long().matmul(w.cpu().long())
                       .to(torch.int32))


@pytest.mark.parametrize("fmt", ["rns8", "bf16"])
def test_verify_paged_equals_sequential_decode_on_card(gen, fmt):
    """One folded verify of V = 5 tokens a slot equals 5 decode steps bit
    for bit on the card (logits and page bytes), and launches B3 once a
    layer."""
    from repro_torch import kernels

    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system="rns", device="cuda")
    params = model.prepare_params(from_jax_params(load_npz(CKPT), cfg,
                                                  "cuda"))
    nb, ps, n_pmax, V, plen = 3, 8, 3, 5, 12
    rng = np.random.default_rng(3)
    _, cache = model.prefill(params, rng.integers(0, cfg.vocab, (nb, plen)),
                             s_max=n_pmax * ps)
    pools = [kvp.make_paged_kv(cfg.n_layers, 1 + nb * n_pmax, ps, cfg.n_kv,
                               cfg.hd, fmt=fmt, device="cuda")
             for _ in range(2)]
    tab = torch.arange(1, 1 + nb * n_pmax, dtype=torch.int32,
                       device="cuda").reshape(nb, n_pmax)
    for pool in pools:
        kvp.scatter_prefill(pool, cache[0], cache[1], tab, ps)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (nb, V))).cuda()
    pos0 = torch.full((nb,), plen, dtype=torch.int32, device="cuda")
    rows = [model.decode_paged(params, toks[:, j:j + 1], pools[0], tab,
                               pos0 + j, page_size=ps)[0] for j in range(V)]
    kernels.reset_launch_counts()
    logits, _ = model.verify_paged(params, toks, pools[1], tab, pos0,
                                   page_size=ps)
    assert kernels.launch_counts()["paged_decode"] == cfg.n_layers
    for j in range(V):
        assert torch.equal(logits[:, j], rows[j])
    for a, b in zip(*pools):
        la = [a.planes, a.scale] if fmt != "bf16" else [a]
        lb = [b.planes, b.scale] if fmt != "bf16" else [b]
        for x, y in zip(la, lb):
            assert torch.equal(x[:, 1:], y[:, 1:])


@pytest.mark.parametrize("spec", ["ngram:4", "rns:3"])
def test_spec_serving_card_matches_cpu(gen, spec):
    """Speculative tokens on the card equal the CPU's and plain decoding's
    on the reduced checkpoint (rns8 pages)."""
    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(CKPT)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    res = {}
    for dev, sp in (("cuda", spec), ("cpu", spec), ("cuda", None)):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=3,
                            s_max=23, page_size=8, kv_format="rns8",
                            device=dev, spec=sp)
        res[dev, sp] = eng.generate({"tokens": prompts}, max_new=12)
    np.testing.assert_array_equal(res["cuda", spec].tokens,
                                  res["cpu", spec].tokens)
    np.testing.assert_array_equal(res["cuda", spec].tokens,
                                  res["cuda", None].tokens)
    assert res["cuda", spec].stats.spec == res["cpu", spec].stats.spec


def test_sdrns_serving_card_matches_cpu(gen):
    """The reduced checkpoint under system="sdrns" (P21 digit planes, rns8
    pages): the card's tokens equal the CPU's and the rns serve's, and the
    card ran the SD kernels."""
    from repro_torch import kernels

    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(CKPT)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    res = {}
    for dev, system in (("cuda", "sdrns"), ("cpu", "sdrns"), ("cpu", "rns")):
        model = build_model(cfg, system=system, device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=3,
                            s_max=19, page_size=8, kv_format="rns8",
                            device=dev)
        kernels.reset_launch_counts()
        res[dev, system] = eng.generate({"tokens": prompts}, max_new=8)
        if dev == "cuda":
            counts = kernels.launch_counts()
    L = cfg.n_layers
    assert counts["sdrns_matmul"] == 7 * L
    assert counts["sdrns_matvec"] == 1 + 7 * (7 * L + 1)
    assert counts["rns_matmul"] == 0
    np.testing.assert_allclose(res["cuda", "sdrns"].prefill_logits,
                               res["cpu", "sdrns"].prefill_logits, rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(res["cuda", "sdrns"].tokens,
                                  res["cpu", "sdrns"].tokens)
    np.testing.assert_array_equal(res["cpu", "sdrns"].tokens,
                                  res["cpu", "rns"].tokens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,hd,T,bk", [
    (3, 8, 2, 16, 72, 32), (2, 4, 4, 112, 50, 16), (2, 32, 8, 128, 321, 64),
    (1, 4, 4, 112, 600, 512), (3, 32, 8, 128, 600, 512),
    (3, 8, 8, 112, 600, 512)])
def test_flash_decode_kernel(gen, dtype, B, H, Kv, hd, T, bk):
    """B5 against its plain version, partial by partial: GQA g = 4 and 1,
    head_dim 16, 112 and 128, a ragged last chunk, kv_len inside the first
    chunk (later chunks all masked) and at T, chunks of 512 rows (longer
    than the rows a block keeps in flight, 64 at head_dim 128).  f32
    caches at the reference's 2e-5; bf16 caches round p to bf16 on both
    sides (an exp one ulp apart can round to the neighbouring bf16 value)."""
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").to(dtype)
    kv_len = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    kv_len[-1] = T
    kv_len[0] = 5           # inside the first chunk (B = 1: the only row)
    out = fa.flash_decode_cuda(q, k, v, kv_len, bk)
    ref = fa.flash_decode_ref(q, k, v, kv_len, bk)
    tol = 2e-5 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(out[1], ref[1], rtol=2e-5, atol=2e-5)
    for a, b in ((out[0], ref[0]), (out[2], ref[2])):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    torch.testing.assert_close(merge_decode_partials(*out),
                               merge_decode_partials(*ref), rtol=tol,
                               atol=tol)
    n_dead = -(-5 // bk)
    assert (out[1][0, :, n_dead:] == -1e30).all()
    assert (out[2][0, :, n_dead:] == 0).all()


def test_flash_decode_equals_paged_decode_at_page_size(gen):
    """The dense kernel with bk = page size gives the paged kernel's
    partials over the same rows bit for bit (one chunk body)."""
    B, H, Kv, hd, ps, n_p = 3, 32, 8, 128, 64, 5
    T = ps * n_p - 7
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    kv_len = torch.tensor([1, 130, T], dtype=torch.int32, device="cuda")
    pad = (0, 0, 0, 0, 0, ps * n_p - T)
    kp = torch.nn.functional.pad(k, pad).reshape(B * n_p, ps, Kv, hd)
    vp = torch.nn.functional.pad(v, pad).reshape(B * n_p, ps, Kv, hd)
    tab = torch.arange(B * n_p, dtype=torch.int32,
                       device="cuda").reshape(B, n_p)
    dense = fa.flash_decode_cuda(q, k, v, kv_len, ps)
    paged = fa.paged_decode_cuda(q, kp, vp, None, None, tab, kv_len, ps)
    for a, b in zip(dense, paged):
        assert torch.equal(a, b)


def test_hybrid_serving_card_matches_cpu(gen):
    """Reduced zamba2 (4 Mamba2 layers, 2 shared-block applications) under
    rns over the dense cache: the card's prefill logits agree with the
    CPU's and its greedy tokens are equal; the card ran B1, B2 and B5,
    and B9 once a B1 launch."""
    from repro_torch import kernels

    cfg = get_config("zamba2-7b").reduced()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8))
    float_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                            s_max=15, device=dev)
        kernels.reset_launch_counts()
        res[dev] = eng.generate({"tokens": prompts}, max_new=6)
        if dev == "cuda":
            counts = kernels.launch_counts()
    # 5 decode steps; per step 4 Mamba2 layers x 2 projections, 2 shared
    # blocks x (in_proj, q, k, v, o, gate, up, down) and the logits
    assert counts["flash_decode"] == 2 * 5
    assert counts["flash_attention"] == 2
    assert counts["rns_matmul"] == 6 * (4 * 2 + 2 * 8 + 1)
    assert counts["rns_decode"] == counts["rns_matmul"]
    assert counts["paged_decode"] == 0
    np.testing.assert_allclose(res["cuda"].prefill_logits,
                               res["cpu"].prefill_logits, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)


def _tree_to(node, dev):
    if isinstance(node, dict):
        return {k: _tree_to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, dev) for v in node]
    return node.to(dev)


@pytest.mark.parametrize("M", [1, 8, 16, 17, 240])
@pytest.mark.parametrize("S,K,N", [(5, 200, 130), (64, 256, 176),
                                   (3, 4160, 300)])
def test_rns_matmul_kernel_stack_mode(gen, S, M, K, N):
    """Stack mode on both schedules: one launch for S slices, bit for bit
    the plain version's slice loop and S launches of their own; the
    activation passed channel-major as the stacked rns_run passes it, and
    as a K segment view at an odd offset."""
    a_cs = torch.randint(-64, 65, (3, S, M, K), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)
    b = torch.randint(-64, 65, (S, 3, K, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    a = a_cs.movedim(0, 1)                    # (S, 3, M, K), not copied
    for lo in (0, K // 3 + 1):
        av, bv = a[..., lo:], b[:, :, lo:]
        before = rm.launches
        out = rm.rns_matmul_cuda(av, bv, P21.moduli)
        assert rm.launches == before + 1
        assert torch.equal(out, rm.rns_matmul_ref(av, bv, P21.moduli))
        for s in range(0, S, max(1, S // 4)):
            assert torch.equal(out[s], rm.rns_matmul_cuda(av[s], bv[s],
                                                          P21.moduli))


@pytest.mark.parametrize("name", ["P16", "P21", "P24", "P33", "CRT40",
                                  "KV8", "KV4", "P21R2"])
@pytest.mark.parametrize("M,N", [(37, 130), (8, 4096), (15, 1001),
                                 (512, 4096)])
def test_rns_decode_kernel_bit_exact(gen, name, M, N):
    """B9 against its plain version (``from_residues``) on random int32
    representatives and centred residues: each slice alone, a stack of 3
    (one launch), and the stack added twice into a sum in place.  Planes of
    37 x 130 and 15 x 1001 elements are no whole number of 16 bytes (the
    scalar path); 8 x 4096 take the 16-byte one; 512 x 4096 take more
    blocks than the grid holds, so the grid-stride loop runs."""
    from repro_torch.core import moduli as mm
    from repro_torch.kernels import rns_decode as rd

    mset = getattr(mm, name)
    info = mset.info
    res = torch.randint(-2**31, 2**31, (3, mset.num_channels, M, N),
                        generator=gen, device="cuda",
                        dtype=torch.int64).to(torch.int32)
    res[:, :, ::2] = mset.center(res[:, :, ::2].movedim(1, 0)).movedim(0, 1)
    for s in range(3):
        assert torch.equal(rd.rns_decode_cuda(res[s], info).cpu(),
                           rd.rns_decode_ref(res[s].cpu(), info))
    before = rd.launches
    stacked = rd.rns_decode_cuda(res, info)
    assert rd.launches == before + 1
    assert torch.equal(stacked.cpu(), rd.rns_decode_ref(res.cpu(), info))
    total = torch.zeros((3, M, N), dtype=torch.int32, device="cuda")
    for _ in range(2):
        assert rd.rns_decode_cuda(res, info, total) is total
    assert torch.equal(total, 2 * stacked)


def test_moe_serving_card_matches_cpu(gen):
    """Reduced moonshot (2 layers, 4 experts, top-2) under rns on rns8
    pages: the card's prefill logits agree with the CPU's and its greedy
    tokens are equal; every stacked expert einsum is one B1 launch, and
    one B9 launch decodes it."""
    from repro_torch import kernels

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    float_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                            s_max=17, page_size=8, kv_format="rns8",
                            device=dev)
        kernels.reset_launch_counts()
        res[dev] = eng.generate({"tokens": prompts}, max_new=6)
        if dev == "cuda":
            counts = kernels.launch_counts()
    # per forward: 2 layers x (q, k, v, o + 3 stacked expert einsums) and
    # the logits; 1 prefill + 5 decode steps
    assert counts["rns_matmul"] == 6 * (2 * 7 + 1)
    assert counts["rns_decode"] == counts["rns_matmul"]
    assert counts["flash_attention"] == 2
    assert counts["paged_decode"] == 2 * 5
    np.testing.assert_allclose(res["cuda"].prefill_logits,
                               res["cpu"].prefill_logits, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)


def test_ssm_serving_card_matches_cpu(gen):
    """Reduced mamba2 (2 Mamba2 layers, no attention) under rns from its
    SSM state: card == CPU, and only B1 ran, each product decoded by
    B9."""
    from repro_torch import kernels

    cfg = get_config("mamba2-780m").reduced()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8))
    float_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                            s_max=15, device=dev)
        kernels.reset_launch_counts()
        res[dev] = eng.generate({"tokens": prompts}, max_new=6)
        if dev == "cuda":
            counts = kernels.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {
        "rns_matmul": 6 * (2 * 2 + 1), "rns_decode": 6 * (2 * 2 + 1)}
    np.testing.assert_allclose(res["cuda"].prefill_logits,
                               res["cpu"].prefill_logits, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)


@pytest.mark.parametrize("B,Sq,T,H,Kv,hd", [
    (2, 300, 300, 12, 12, 64), (3, 8, 1500, 12, 12, 64),
    (2, 1, 77, 4, 2, 64)])
def test_flash_attention_kernel_bf16_non_causal_hd64(gen, B, Sq, T, H, Kv,
                                                      hd):
    """B2 without the causal mask at head_dim 64: whisper's encoder (Sq =
    T) and cross-attention (a short decoder prompt against the encoder
    memory)."""
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, T, Kv, hd, generator=gen, device="cuda").bfloat16()
    out = fa.flash_attention_cuda(q, k, v, None, causal=False)
    ref = fa.flash_attention_ref(q, k, v, None, causal=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("M,K,N", [(8, 768, 51865), (64, 768, 51865),
                                   (8, 3072, 1001), (300, 5120, 4097)])
def test_rns_matmul_kernel_odd_columns(gen, M, K, N):
    """B1 with an odd row stride (whisper's vocabulary): the byte-load path
    on both schedules, bit for bit."""
    a = torch.randint(-64, 65, (3, M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-64, 65, (3, K, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    assert torch.equal(rm.rns_matmul_cuda(a, b, P21.moduli),
                       rm.rns_matmul_ref(a, b, P21.moduli))


def test_flash_decode_kernel_cross_memory(gen):
    """B5 at whisper's shapes, hd 64: the self cache (T 448, one chunk)
    and the cross memory (T 1500, every row valid, three chunks)."""
    for T, lo in ((448, 9), (1500, 1500)):
        q = torch.randn(4, 12, 64, generator=gen, device="cuda").bfloat16()
        k = torch.randn(4, T, 12, 64, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(4, T, 12, 64, generator=gen,
                        device="cuda").bfloat16()
        kv_len = torch.randint(lo, T + 1, (4,), generator=gen, device="cuda",
                               dtype=torch.int32)
        bk = min(512, T)
        out = merge_decode_partials(*fa.flash_decode_cuda(q, k, v, kv_len,
                                                          bk))
        ref = merge_decode_partials(*fa.flash_decode_ref(q, k, v, kv_len,
                                                         bk))
        torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_vlm_audio_serving_card_matches_cpu(gen, arch):
    """Reduced whisper (dense caches) and reduced pixtral (rns8 pages) under
    rns: the card's prefill logits agree with the CPU's and its greedy
    tokens are equal."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (3, 6))
    n = 12 if cfg.is_encdec else cfg.n_img_tokens
    extra = torch.as_tensor(rng.standard_normal((3, n, cfg.d_model)) * 0.1,
                            dtype=torch.float32)
    float_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        if cfg.is_encdec:
            eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                                s_max=n, device=dev)
            inputs = {"tokens": prompts, "frames": extra.to(dev)}
        else:
            eng = ServingEngine(model, _tree_to(float_params, dev), batch=3,
                                s_max=6 + n + 7, page_size=8,
                                kv_format="rns8", device=dev)
            inputs = {"tokens": prompts, "patches": extra.to(dev)}
        res[dev] = eng.generate(inputs, max_new=6)
    np.testing.assert_allclose(res["cuda"].prefill_logits,
                               res["cpu"].prefill_logits, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res["cuda"].tokens, res["cpu"].tokens)


def test_scheduler_card_matches_cpu(gen):
    """The continuous scheduler on the reduced checkpoint (B 2, page 8,
    rns8 pages): mid-decode admissions, a shared prefix and a skipped
    prefill give the CPU's tokens and pool counters on the card."""
    from repro_torch.serving.scheduler import Request, RequestScheduler

    cfg = get_config("qwen3-8b").reduced()
    tree = load_npz(CKPT)
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    specs = [(base, 5), (rng.integers(0, cfg.vocab, 9).astype(np.int32), 9),
             (base, 4), (np.concatenate([base[:8], base[:3]]), 6),
             (rng.integers(0, cfg.vocab, 4).astype(np.int32), 7)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        eng = ServingEngine(model, from_jax_params(tree, cfg, dev), batch=2,
                            s_max=24, page_size=8, kv_format="rns8",
                            device=dev)
        res = RequestScheduler(eng).serve(
            [Request(rid=i, tokens=t, max_new=m)
             for i, (t, m) in enumerate(specs)])
        out[dev] = ([r.result.tolist() for r in res],
                    dataclasses.asdict(eng.pool.stats))
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1]["prefix_hits"] >= 3


# ---------------------------------------------------------------------------
# Training: the per-call residue matmul and the train step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system", ["rns", "sdrns"])
@pytest.mark.parametrize("M", [4, 37, 300])
def test_per_call_dense_card_equals_prepared_and_cpu(gen, system, M):
    """The per-call forward of a float weight on the card: the prepared
    planes' output and the CPU's (plain versions) bit for bit; its
    straight-through gradients the CPU's within f32 summation order."""
    from repro_torch.models import linear
    from repro_torch.quant import residency

    w = torch.randn(200, 72, generator=gen, device="cuda")
    x = torch.randn(M, 200, generator=gen, device="cuda")
    g = torch.randn(M, 72, generator=gen, device="cuda")
    kw = dict(system=system, compute_dtype=torch.float32)
    out, grads = {}, {}
    for dev in ("cuda", "cpu"):
        wt = w.detach().to(dev).requires_grad_(True)
        xt = x.detach().to(dev).requires_grad_(True)
        y = linear.dense({"w": wt}, xt, **kw)
        (y * g.to(dev)).sum().backward()
        out[dev], grads[dev] = y.detach().cpu(), (xt.grad.cpu(),
                                                 wt.grad.cpu())
    prep = residency.prepare_dense({"w": w}, system=system)
    assert torch.equal(linear.dense(prep, x, **kw).cpu(), out["cuda"])
    assert torch.equal(out["cuda"], out["cpu"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_train_step_card_matches_cpu(gen):
    """One micro-batched AdamW step of the reduced qwen3-8b under rns with
    remat on the card: (2 x 7 x L + 1) B1 launches a micro-batch, loss
    within 1e-5 of the CPU's, parameters after the step within the
    reference's limits; the sdrns step equal to the rns step bit for bit,
    with B6 launched."""
    from repro_torch import kernels
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), remat=True)
    batch = TokenPipeline(cfg.vocab, 16, 8, seed=3).batch_at(0)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=0, total_steps=4)
    tree = load_npz(CKPT)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, system="rns", device=dev)
        params = from_jax_params(tree, cfg, dev)
        kernels.reset_launch_counts()
        res[dev] = make_train_step(model, opt, 2)(
            params, init_opt_state(params, opt), batch)
        if dev == "cuda":
            assert kernels.launch_counts()["rns_matmul"] == 2 * (
                2 * 7 * cfg.n_layers + 1)
    torch.testing.assert_close(res["cuda"][2]["loss"].cpu(),
                               res["cpu"][2]["loss"], rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(res["cuda"][0]), tree_leaves(res["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5)
    params = from_jax_params(tree, cfg, "cuda")
    lg = {}
    for system in ("rns", "sdrns"):
        kernels.reset_launch_counts()
        lg[system] = loss_and_grads(build_model(cfg, system=system,
                                                device="cuda"),
                                    params, batch)
    assert kernels.launch_counts()["sdrns_matmul"] == 2 * 7 * cfg.n_layers + 1
    assert torch.equal(lg["rns"][0][0], lg["sdrns"][0][0])
    for a, b in zip(tree_leaves(lg["rns"][1]), tree_leaves(lg["sdrns"][1])):
        assert torch.equal(a, b)


def test_engine_unprepared_card_equals_prepared(gen):
    """``ServingEngine(prepare=False)`` on the card: the prepared engine's
    prefill logits and tokens bit for bit."""
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, system="rns", device="cuda")
    params = from_jax_params(load_npz(CKPT), cfg, "cuda")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    res = [ServingEngine(model, params, batch=3, s_max=17, page_size=8,
                         kv_format="rns8", device="cuda", prepare=p
                         ).generate({"tokens": prompts}, max_new=6)
           for p in (True, False)]
    np.testing.assert_array_equal(res[0].prefill_logits,
                                  res[1].prefill_logits)
    np.testing.assert_array_equal(res[0].tokens, res[1].tokens)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_rns_tensor_matmul_card_launches_b1(gen, batch):
    """``RnsTensor.matmul`` on the card is one B1 launch (a batch as B1's
    stack) equal to the CPU's plain version; int32 planes that fit a byte
    are cast, the wider sets and lazy planes past int8 raise."""
    from repro_torch.core.moduli import P24
    from repro_torch.core.rns import RnsTensor

    a = torch.randint(-7, 8, (*batch, 37, 300), generator=gen,
                      device="cuda", dtype=torch.int32)
    b = torch.randint(-7, 8, (*batch, 300, 65), generator=gen,
                      device="cuda", dtype=torch.int32)
    ta, tb = RnsTensor.from_int(a, P21), RnsTensor.from_int(b, P21)
    rm.reset_launches()
    out = ta.matmul(tb)
    assert rm.launches == 1
    cpu = RnsTensor.from_int(a.cpu(), P21).matmul(RnsTensor.from_int(
        b.cpu(), P21))
    assert torch.equal(out.residues.cpu(), cpu.residues)
    assert torch.equal(out.to_int().cpu(),
                       (a.double() @ b.double()).to(torch.int32).cpu())
    sixty = RnsTensor.from_int(torch.full_like(a, 60), P21)
    with pytest.raises(ValueError, match="flush"):
        sixty.lazy_add(sixty).lazy_add(sixty).matmul(tb)
    with pytest.raises(ValueError, match="exceed 256"):
        RnsTensor.from_int(a, P24).matmul(RnsTensor.from_int(b, P24))
    with pytest.raises(TypeError, match="int8 planes"):
        rm.rns_matmul_cuda(ta.residues, tb.residues, P21.moduli)
    assert rm.launches == 1


@pytest.mark.parametrize("system", ["rns", "sdrns"])
def test_narrow_cnn_card_matches_cpu(gen, system):
    """A narrow CNN (``data/cifar.py``; its fc K 2048 in two int6
    segments, its last fc at M 3 on B7 under sdrns) on the card equals the
    CPU's plain versions bit for bit."""
    from repro_torch.data import cifar

    spec = cifar.CnnSpec("narrow", (
        ("conv", 8, 3, 1), ("pool", 2), ("conv", 32, 3, 1), ("pool", 2),
        ("fc", 32), ("fc", 10)))
    params = cifar.init_cnn(gen, spec, device="cuda")
    x = torch.from_numpy(cifar.synthetic_cifar(3, split="test")[0])
    kw = {"system": system, "bits": 6, "compute_dtype": torch.float32}
    with torch.no_grad():
        card = cifar.cnn_forward(params, spec, x.cuda(), dense_kw=kw)
        cpu = cifar.cnn_forward(
            {k: {n: t.cpu() for n, t in v.items()} for k, v in
             params.items()}, spec, x, dense_kw=kw)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("n,layout", [(2, "col"), (2, "row"), (3, "chan")])
def test_mesh_plans_on_card_equal_one_launch(tmp_path, n, layout):
    """The column and row plans on 2 ranks and the channel plan on 3, ranks
    that share the card in a gloo group: one full-width qwen3 projection
    (w_up, K 4096 x N 12288) at M 8 and M 2048, and w_down (K 12288) at M
    8; each rank's output equals the single-device product (one B1 launch)
    bit for bit, with one B1 launch a rank on its block (N / 2 columns,
    K / 2 rows, or one of P21's channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh

    shapes = [(4096, 12288, 8), (4096, 12288, 2048), (12288, 4096, 8)]
    ranks = torch_mesh.RankRun(torch_mesh.card_plan_body, n, tmp_path, n,
                               layout, shapes).results(timeout=600)
    for out in ranks:
        for (K, N, M), r in out.items():
            assert r["equal"], (K, N, M)
            assert r["launches"] == (1, 1)
            assert r["block"] == {"col": (3, K, N // 2),
                                  "row": (3, K // 2, N),
                                  "chan": (1, K, N)}[layout]
