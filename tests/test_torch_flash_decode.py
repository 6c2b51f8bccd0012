"""Port parity: split-KV decode over the dense cache (kernel B5's plain
version).

``flash_decode_ref`` (what the port's kernel computes) against the JAX
package's ``flash_decode_pallas`` in interpret mode, partial by partial,
and the port's ``numerics.attention.flash_decode`` against the
reference's ``numerics.flash_decode(backend="interpret")``.

Tolerances: f32 caches at the reference's own 2e-5
(``tests/test_flash_attn.py``).  bf16 caches: both sides round ``p`` to
bf16 before the PV product, and an ``exp`` one f32 ulp apart (XLA's and
PyTorch's CPU ``exp`` differ in the last ulp) can round to the
neighbouring bf16 value, which moves one weight by 2**-8 of itself; so the
bf16 partials are held at 2e-3 relative to their scale, ``m`` (taken before
any rounding) at 2e-5.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_decode_pallas
from repro.numerics import attention as jattn
from repro_torch.kernels import flash_attn as tfa
from repro_torch.numerics import attention as tattn

from torch_threads import one_thread  # noqa: F401

TOL = 2e-5
BF16_TOL = 2e-3

CASES = [
    # (B, H, Kv, hd, T, bk, kv_len)
    (2, 8, 2, 16, 64, 32, [64, 33]),          # g = 4, bk | T
    (3, 4, 4, 16, 72, 32, [72, 5, 40]),       # g = 1, ragged last chunk
    (2, 8, 2, 112, 96, 32, [7, 96]),          # hd 112; 7 < bk: later
    #                                           chunks all masked
    (2, 4, 4, 112, 50, 16, [1, 50]),          # hd 112, g = 1, ragged
    (1, 8, 2, 16, 40, 40, [23]),              # one chunk
]
IDS = [f"B{c[0]}H{c[1]}Kv{c[2]}hd{c[3]}T{c[4]}bk{c[5]}" for c in CASES]


def _inputs(case, dtype):
    B, H, Kv, hd, T, bk, kv_len = case
    rng = np.random.default_rng(sum(case[:6]))
    q = (rng.normal(size=(B, H, hd)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, T, Kv, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, T, Kv, hd)) * 0.5).astype(np.float32)
    # garbage past each row's kv_len must not reach the output
    tail = np.arange(T)[None, :, None, None] >= np.array(
        kv_len)[:, None, None, None]
    k = np.where(tail, 123.0, k).astype(np.float32)
    v = np.where(tail, -55.0, v).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return jx, tx, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_partials_match_pallas_interpret(case, dtype):
    bk = case[5]
    (jq, jk, jv), (tq, tk, tv), kv_len = _inputs(case, dtype)
    jo, jm, jl = flash_decode_pallas(jq, jk, jv, jnp.asarray(kv_len),
                                     bk=bk, interpret=True)
    to, tm, tl = tfa.flash_decode_ref(tq, tk, tv, torch.from_numpy(kv_len),
                                      bk)
    n_k = -(-case[4] // bk)
    assert to.shape == (case[0], case[1], case[3], n_k)
    assert to.dtype == tm.dtype == tl.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=TOL)
    tol = TOL if dtype == "f32" else BF16_TOL
    for t, j in ((to, jo), (tl, jl)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=tol * max(1.0, np.abs(j).max()))
    # chunks past kv_len: o = 0, l = 0, m = -1e30 on both sides
    first_dead = -(-kv_len // bk)
    for b, j0 in enumerate(first_dead):
        assert (to[b, :, :, j0:] == 0).all() and (tl[b, :, j0:] == 0).all()
        assert (tm[b, :, j0:] == -1e30).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_merged_matches_reference_flash_decode(case, dtype):
    bk = case[5]
    (jq, jk, jv), (tq, tk, tv), kv_len = _inputs(case, dtype)
    j = jattn.flash_decode(jq, jk, jv, kv_len=jnp.asarray(kv_len),
                           backend="interpret", bk=bk)
    t = tattn.flash_decode(tq, tk, tv, kv_len=torch.from_numpy(kv_len),
                           bk=bk)
    assert t.shape == tq.shape and t.dtype == torch.float32
    tol = TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


def test_default_block_and_override():
    """``bk = pick_block(T, 512)``: one chunk up to T = 512 (rounded up to
    8), 512-row chunks beyond; ``set_decode_block`` overrides it."""
    assert tattn.pick_block(321, 512) == 328
    assert tattn.pick_block(4096, 512) == 512
    assert tattn.pick_block(1, 512) == 8
    case = (2, 4, 4, 16, 600, 0, [600, 300])
    (jq, jk, jv), (tq, tk, tv), kv_len = _inputs(case, "f32")
    kl = torch.from_numpy(kv_len)
    auto = tattn.flash_decode(tq, tk, tv, kv_len=kl)
    np.testing.assert_allclose(
        auto.numpy(), np.asarray(jattn.flash_decode(
            jq, jk, jv, kv_len=jnp.asarray(kv_len), backend="interpret")),
        rtol=0, atol=TOL)
    prev = tattn.set_decode_block(64)
    try:
        assert tattn.set_decode_block(64) == 64
        blocked = tattn.flash_decode(tq, tk, tv, kv_len=kl)
    finally:
        tattn.set_decode_block(prev)
    assert tattn.set_decode_block(prev) is None
    np.testing.assert_allclose(blocked.numpy(), auto.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_equals_paged_at_page_size(dtype):
    """With ``bk`` equal to the page size the dense partials are the paged
    decode's over the same rows, bit for bit (the twin the serving tests
    and the smoke's [serve-dense] rely on)."""
    B, H, Kv, hd, ps, n_p = 3, 8, 2, 16, 8, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, hd, generator=g).to(dtype)
    k = torch.randn(B, ps * n_p - 3, Kv, hd, generator=g).to(dtype)
    v = torch.randn(B, ps * n_p - 3, Kv, hd, generator=g).to(dtype)
    kv_len = torch.tensor([1, 17, ps * n_p - 3], dtype=torch.int32)
    pad = (0, 0, 0, 0, 0, 3)
    pages_k = torch.nn.functional.pad(k, pad).reshape(B * n_p, ps, Kv, hd)
    pages_v = torch.nn.functional.pad(v, pad).reshape(B * n_p, ps, Kv, hd)
    tab = torch.arange(B * n_p, dtype=torch.int32).reshape(B, n_p)
    dense = tfa.flash_decode_ref(q, k, v, kv_len, ps)
    paged = tfa.paged_decode_ref(q, pages_k, pages_v, None, None, tab,
                                 kv_len, ps)
    for a, b in zip(dense, paged):
        assert torch.equal(a, b)


def test_wrapper_takes_plain_version_on_cpu():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    q = torch.randn(1, 4, 16)
    k = torch.randn(1, 9, 2, 16)
    out = tattn.flash_decode(q, k, k, kv_len=torch.tensor([5]))
    assert out.shape == (1, 4, 16)
    assert kernels.launch_counts()["flash_decode"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_decode_cuda(q, k, k, torch.tensor([5], dtype=torch.int32),
                              8)
