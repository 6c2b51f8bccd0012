"""Port parity: KV page quantization and writes give the reference's bytes.

Page bytes and scales after ``quantize_to_format``, ``scatter_prefill`` and
``append_token`` must equal the JAX package's bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.numerics import kv_pages as jkv
from repro_torch.numerics import kv_pages as tkv

FORMATS = ["bf16", "rns8", "rns4"]


def _leaves(paged):
    """(k, v) as numpy: (planes, scale) pairs for residue pools."""
    out = []
    for leaf in paged:
        if hasattr(leaf, "planes"):
            p, s = leaf.planes, leaf.scale
            if isinstance(p, torch.Tensor):
                out += [p.numpy(), s.numpy()]
            else:
                out += [np.asarray(p), np.asarray(s)]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.to(torch.float32).numpy())
        else:
            out.append(np.asarray(leaf.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("name", ["rns8", "rns4"])
def test_quantize_to_format_bit_exact(name):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # all-zero head row
    jp, js = jkv.quantize_to_format(jnp.asarray(x), jkv.KV_FORMATS[name])
    tp, ts = tkv.quantize_to_format(torch.from_numpy(x), tkv.KV_FORMATS[name])
    assert tp.dtype == torch.uint8 and tp.shape == tuple(jp.shape)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tkv.KV_FORMATS[name].qmax == jkv.KV_FORMATS[name].qmax


@pytest.mark.parametrize("name", FORMATS)
def test_scatter_prefill_and_append_token_bit_exact(name):
    L, B, S, Kv, hd, ps, n_pmax = 2, 3, 11, 2, 16, 4, 4
    P = 1 + B * n_pmax
    rng = np.random.default_rng(1)
    kd = rng.normal(0, 1, (L, B, S, Kv, hd)).astype(np.float32)
    vd = rng.normal(0, 1, (L, B, S, Kv, hd)).astype(np.float32)
    # the engine's prefill cache is bf16: feed both sides the same bf16 values
    kd_b = jnp.asarray(kd, jnp.bfloat16)
    vd_b = jnp.asarray(vd, jnp.bfloat16)
    tab = (1 + rng.permutation(B * n_pmax)).reshape(B, n_pmax).astype(
        np.int32)
    jp = jkv.make_paged_kv(L, P, ps, Kv, hd, fmt=name)
    jp = jkv.scatter_prefill(jp, kd_b, vd_b, jnp.asarray(tab), ps)
    tp = tkv.make_paged_kv(L, P, ps, Kv, hd, fmt=name, device="cpu")
    tp = tkv.scatter_prefill(
        tp, torch.tensor(np.asarray(kd_b.astype(jnp.float32))).bfloat16(),
        torch.tensor(np.asarray(vd_b.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(tab), ps)
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_array_equal(a, b)

    # one decode-step append per slot into layer 1, at ragged positions
    pos = np.array([11, 12, 15], np.int32)
    pages = tab[np.arange(B), pos // ps]
    offs = pos % ps
    kn = rng.normal(0, 1, (B, Kv, hd)).astype(np.float32)
    vn = rng.normal(0, 1, (B, Kv, hd)).astype(np.float32)
    kn_b, vn_b = jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16)
    jl = jkv.append_token(jkv.layer_slice(jp, 1), kn_b, vn_b,
                          jnp.asarray(pages), jnp.asarray(offs))
    jp = jkv.layer_update(jp, 1, jl)
    tl = tkv.append_token(
        tkv.layer_slice(tp, 1),
        torch.tensor(np.asarray(kn_b.astype(jnp.float32))).bfloat16(),
        torch.tensor(np.asarray(vn_b.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(pages), torch.from_numpy(offs))
    tp = tkv.layer_update(tp, 1, tl)
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_layer_update_copies_foreign_layer():
    tp = tkv.make_paged_kv(2, 3, 4, 2, 8, fmt="rns8", device="cpu")
    other = tkv.make_paged_kv(1, 3, 4, 2, 8, fmt="rns8", device="cpu")
    other.k.planes.fill_(7)
    tkv.layer_update(tp, 1, tkv.layer_slice(other, 0))
    assert (tp.k.planes[1] == 7).all() and (tp.k.planes[0] == 0).all()


@pytest.mark.parametrize("name", ["rns8", "rns4"])
def test_compiled_reference_quantizer_scales_within_one_ulp(name):
    """Compiled under ``jax.jit`` (as the reference's engine runs it), the
    reference's page quantizer computes ``amax / qmax`` as
    ``amax * (1 / qmax)``; the port divides, as the reference's own eager
    function does.  The two sets of scales stay within one f32 ulp."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (64, 4, 16)).astype(np.float32)
    fmt = jkv.KV_FORMATS[name]
    _, js = jax.jit(jkv.quantize_to_format, static_argnums=(1,))(
        jnp.asarray(x), fmt)
    _, ts = tkv.quantize_to_format(torch.from_numpy(x), tkv.KV_FORMATS[name])
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
