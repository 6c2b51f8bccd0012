"""Port parity: flash prefill attention and paged split-KV decode.

The port's plain versions (what its kernels compute) against the JAX Pallas
kernels in interpret mode, at the reference's own tolerances
(``tests/test_flash_attn.py``: 2e-5 in f32, 2e-2 in bf16).  The reduced
qwen3 shape has H == Kv, so GQA (g > 1) gets its own cases here.  The
prefill is also held in bf16, the dtype of the full-width serves, at the
head_dims of qwen3-8b (128) and zamba2-7b (112): the card's tensor-core
kernel is held against this plain version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import (flash_attention_pallas,
                                      flash_paged_decode_pallas)
from repro.numerics import attention as jattn
from repro.numerics import kv_pages as jkv
from repro_torch.kernels import flash_attn as tfa
from repro_torch.numerics import attention as tattn
from repro_torch.numerics import kv_pages as tkv
from repro_torch.numerics.tensor import ResidueTensor

from torch_threads import one_thread  # noqa: F401

TOL = 2e-5
BF16_TOL = 2e-2      # the reference's bf16 tolerance (test_flash_attn._tol)


def _qkv(seed, B, Sq, H, Kv, hd, T):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=s) * 0.5).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))


CASES = [
    # (B, Sq, T, H, Kv, hd, kv_len, causal, bq, bk, dtype)
    (2, 64, 64, 4, 4, 16, None, True, 32, 32, "float32"),         # g = 1
    (2, 64, 96, 4, 2, 32, None, False, 32, 32, "float32"),        # g = 2
    (3, 32, 80, 4, 2, 16, [17, 80, 1], False, 32, 32, "float32"),  # ragged
    (2, 48, 72, 4, 2, 16, [50, 72], True, 32, 32, "float32"),     # bq !| S
    (2, 40, 40, 8, 2, 16, [40, 23], True, 16, 16, "float32"),     # g = 4
    # bf16, the serves' dtype
    (2, 48, 72, 4, 2, 16, [50, 72], True, 32, 32, "bfloat16"),
    (2, 40, 40, 8, 2, 16, [40, 23], True, 16, 16, "bfloat16"),
    (2, 64, 96, 4, 2, 32, None, False, 32, 32, "bfloat16"),
    (1, 40, 40, 8, 2, 112, [37], True, 16, 16, "bfloat16"),       # zamba2 hd
    (1, 40, 56, 8, 2, 128, [45], False, 16, 16, "bfloat16"),      # qwen3 hd
    (1, 24, 24, 8, 2, 128, None, True, 16, 16, "bfloat16"),
]


def _case_id(c):
    return (f"B{c[0]}S{c[1]}T{c[2]}H{c[3]}Kv{c[4]}c{int(c[7])}"
            + ("" if c[10] == "float32" else f"-hd{c[5]}-bf16"))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_plain_matches_pallas_interpret(case):
    B, Sq, T, H, Kv, hd, kv_len, causal, bq, bk, dtype = case
    q, k, v = _qkv(sum(case[:6]), B, Sq, H, Kv, hd, T)
    if kv_len is not None:
        # garbage past each row's kv_len must not reach the output
        tail = np.arange(T)[None, :, None, None] >= np.array(
            kv_len)[:, None, None, None]
        k = np.where(tail, 123.0, k).astype(np.float32)
        v = np.where(tail, -55.0, v).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # bf16: both sides take the same bf16 values
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jdt)
                  for x in (tq, tk, tv))
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    j = flash_attention_pallas(jq, jk, jv, jl, causal=causal, bq=bq, bk=bk,
                               interpret=True)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    t = tattn.flash_attention(tq, tk, tv, causal=causal, kv_len=tl)
    assert t.dtype == tdt and t.shape == (B, Sq, H, hd)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)), rtol=tol,
                               atol=tol)


def _pools(fmt_name, L, P, ps, Kv, hd, dense_k, dense_v, tab):
    """The same prefill scattered into a JAX pool and a port pool."""
    jp = jkv.make_paged_kv(L, P, ps, Kv, hd, fmt=fmt_name)
    jp = jkv.scatter_prefill(jp, jnp.asarray(dense_k), jnp.asarray(dense_v),
                             jnp.asarray(tab), ps)
    tp = tkv.make_paged_kv(L, P, ps, Kv, hd, fmt=fmt_name, device="cpu")
    tp = tkv.scatter_prefill(tp, torch.tensor(dense_k), torch.tensor(dense_v),
                             torch.from_numpy(tab), ps)
    return jp, tp


@pytest.mark.parametrize("fmt", ["bf16", "rns8", "rns4"])
@pytest.mark.parametrize("H,Kv", [(4, 4), (8, 2)], ids=["g1", "g4"])
def test_paged_decode_matches_pallas_interpret(fmt, H, Kv):
    B, ps, n_pmax, hd = 3, 8, 4, 16
    P = 1 + B * n_pmax
    rng = np.random.default_rng(H * 10 + len(fmt))
    S = n_pmax * ps
    dense = rng.normal(0, 1, (2, 1, B, S, Kv, hd)).astype(np.float32)
    if fmt == "bf16":  # pages in the cache dtype: round through bf16 once
        dense = np.asarray(jnp.asarray(dense, jnp.bfloat16)
                           .astype(jnp.float32))
    tab = (1 + rng.permutation(B * n_pmax)).reshape(B, n_pmax).astype(
        np.int32)
    tab[2, 3] = 0                                   # a dump-page entry
    kv_len = np.array([5, 32, 17], np.int32)        # ragged, page-unaligned
    q = rng.normal(0, 1, (B, H, hd)).astype(np.float32)
    jp, tp = _pools(fmt, 1, P, ps, Kv, hd, dense[0], dense[1], tab)
    jl, tl = jkv.layer_slice(jp, 0), tkv.layer_slice(tp, 0)

    j = jattn.paged_decode(jnp.asarray(q), jl, jnp.asarray(tab),
                           jnp.asarray(kv_len), page_size=ps,
                           backend="interpret")
    t = tattn.paged_decode(torch.from_numpy(q), tl, torch.from_numpy(tab),
                           torch.from_numpy(kv_len), page_size=ps)
    assert t.dtype == torch.float32 and t.shape == (B, H, hd)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)

    # the partials themselves, against the kernel's outputs
    if fmt == "bf16":
        kr, vr, ks, vs, moduli, pack = jl.k, jl.v, None, None, None, None
        tk, tv, tks, tvs = tl.k, tl.v, None, None
    else:
        kr, vr = jl.k.planes[..., 0, :, :], jl.v.planes[..., 0, :, :]
        ks, vs, moduli = jl.k.scale, jl.v.scale, jl.k.mset.moduli
        tk, tv = tl.k.planes.select(-3, 0), tl.v.planes.select(-3, 0)
        tks, tvs, pack = tl.k.scale, tl.v.scale, tl.k.mset.packed()
    jo = flash_paged_decode_pallas(jnp.asarray(q), kr, vr, jnp.asarray(tab),
                                   jnp.asarray(kv_len), page_size=ps,
                                   k_scale=ks, v_scale=vs, moduli=moduli,
                                   interpret=True)
    to = tfa.paged_decode_ref(torch.from_numpy(q), tk, tv, tks, tvs,
                              torch.from_numpy(tab),
                              torch.from_numpy(kv_len), ps, pack)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_merge_decode_partials_matches_reference():
    rng = np.random.default_rng(9)
    o = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    m = rng.normal(size=(2, 3, 5)).astype(np.float32)
    m[:, :, 4] = -1e30                       # an all-masked chunk
    lsum = rng.uniform(0.5, 3, (2, 3, 5)).astype(np.float32)
    lsum[:, :, 4] = 0.0
    o[:, :, :, 4] = 0.0
    j = jattn.merge_decode_partials(jnp.asarray(o), jnp.asarray(m),
                                    jnp.asarray(lsum))
    t = tattn.merge_decode_partials(torch.from_numpy(o), torch.from_numpy(m),
                                    torch.from_numpy(lsum))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_paged_pool_leaves_are_residue_tensors():
    tp = tkv.make_paged_kv(2, 3, 4, 2, 8, fmt="rns4", device="cpu")
    assert isinstance(tp.k, ResidueTensor) and tp.k.layout == "rns_pack"
    assert tp.k.planes.shape == (2, 3, 4, 1, 2, 4)
    assert tp.k.shape == (2, 3, 4, 2, 8)
