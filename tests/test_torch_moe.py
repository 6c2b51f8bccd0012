"""Port parity of the mixture-of-experts layer and its stacked residue
einsum: ``repro_torch.models.moe``, ``numerics.api.einsum``, the stacked
``runners.rns_run`` and ``linear.stacked_qmatmul``, against the JAX
package (``repro.models.moe``, ``repro.numerics.einsum``).

Inputs are made with numpy from fixed seeds and fed to both packages.
The reference's residue matmuls run through its exact ``ref`` backend.
Integer results must match bit for bit; float outputs within ``TOL``
(f32: the router softmax, SiLU and the k-sum may round in another order
than XLA's, a few ulps).  Routing (expert ids, positions, the keep mask)
must be identical; the reference's routing is read off its own code
(``_ref_routing`` runs ``repro/models/moe.py``'s lines, which ``moe``
does not return).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnx
from repro.core import moduli as jmod
from repro.models import moe as jmoe
from repro.quant import residency as jres
from repro_torch.core.moduli import P21, P21R2
from repro_torch.models import linear, moe
from repro_torch.numerics import api as nx
from repro_torch.numerics import runners
from repro_torch.quant import residency

TOL = 1e-5
D, F, E, K = 32, 48, 4, 2          # reduced moonshot / grok widths


def _params(seed, d=D, f=F, e=E, router_w=None):
    rng = np.random.default_rng(seed)
    s = (2.0 / (d + f)) ** 0.5
    p = {"router": {"w": (rng.standard_normal((d, e)) * 0.5
                          ).astype(np.float32)},
         "w_gate": (rng.standard_normal((e, d, f)) * s).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, f)) * s).astype(np.float32),
         "w_down": (rng.standard_normal((e, f, d)) * s).astype(np.float32)}
    if router_w is not None:
        p["router"]["w"] = router_w.astype(np.float32)
    return p


def _x(seed, B=3, S=8, d=D):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _jax(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _torch(p):
    return jax.tree_util.tree_map(torch.from_numpy, p)


def _ref_routing(router_w, xt, e, k, cf):
    """The reference moe's routing and placement, line for line."""
    logits = jnp.einsum("td,de->te", jnp.asarray(xt, jnp.float32),
                        jnp.asarray(router_w))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    T = xt.shape[0]
    C = jmoe.moe_capacity(T, e, k, cf)
    flat_e = idx.reshape(T * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(gates), np.asarray(idx), np.asarray(pos_in_e),
            np.asarray(pos_in_e < C))


def _check_routing(p, x, e, k, cf):
    xt = x.reshape(-1, x.shape[-1])
    rg, ri, rp, rk = _ref_routing(p["router"]["w"], xt, e, k, cf)
    _, gates, idx = moe.route(torch.from_numpy(p["router"]["w"]),
                              torch.from_numpy(xt), k)
    C = moe.moe_capacity(xt.shape[0], e, k, cf)
    _, pos, keep = moe.place(idx, e, C)
    np.testing.assert_array_equal(idx.numpy(), ri)
    np.testing.assert_array_equal(pos.numpy(), rp)
    np.testing.assert_array_equal(keep.numpy(), rk)
    np.testing.assert_allclose(gates.numpy(), rg, rtol=0, atol=TOL)
    return rk


@pytest.mark.parametrize("T,e,k,cf", [
    (1, 2, 1, 1.25), (8, 64, 6, 1.25), (2048, 64, 6, 1.25), (24, 4, 2, 8.0),
    (24, 8, 2, 1.25), (511, 64, 6, 0.5), (33, 8, 6, 4.0), (7, 2, 2, 0.01)])
def test_capacity_matches_reference(T, e, k, cf):
    assert moe.moe_capacity(T, e, k, cf) == jmoe.moe_capacity(T, e, k, cf)


def test_capacity_at_moonshot_serve_shapes():
    """B 8 decode (8 tokens) and a B 8 x 256 prefill at 64 experts, top-6."""
    assert moe.moe_capacity(8, 64, 6) == 8
    assert moe.moe_capacity(2048, 64, 6) == 240


@pytest.mark.parametrize("system", ["bns", "rns"])
def test_moe_matches_reference(system):
    """Routing, positions, keep mask and gates identical; outputs and aux
    within TOL; under ``rns`` on prepared stacks in both packages."""
    p, x = _params(0), _x(1)
    keep = _check_routing(p, x, E, K, 8.0)
    assert keep.all()
    jp, tp = _jax(p), _torch(p)
    kw = {}
    if system == "rns":
        for name in ("w_gate", "w_up", "w_down"):
            jp[name] = jres.prepare_weight(jp[name], system="rns")
            tp[name] = residency.prepare_weight(tp[name], system="rns")
        kw = {"system": "rns", "impl": "ref"}
    jy, jaux = jmoe.moe(jp, jnp.asarray(x), n_experts=E, top_k=K,
                        capacity_factor=8.0, dense_kw=kw)
    ty = moe.moe(tp, torch.from_numpy(x), n_experts=E, top_k=K,
                 capacity_factor=8.0,
                 dense_kw={"system": system} if kw else None)
    taux = moe.load_balance_loss(tp["router"]["w"], torch.from_numpy(x),
                                 n_experts=E, top_k=K)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=TOL)


def test_moe_drops_match_reference():
    """moe_cf 1.25 and a router skewed to expert 0: most of its slots
    drop; the same slots drop in both packages and the outputs agree."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((D, E)).astype(np.float32) * 0.1
    w[:, 0] += 1.0
    p, x = _params(3, router_w=w), _x(4, B=2, S=16)
    x[..., :] += 0.5                 # column 0's bias dominates the logits
    keep = _check_routing(p, x, E, K, 1.25)
    assert 0 < (~keep).sum() < keep.size
    jp, tp = _jax(p), _torch(p)
    for name in ("w_gate", "w_up", "w_down"):
        jp[name] = jres.prepare_weight(jp[name], system="rns")
        tp[name] = residency.prepare_weight(tp[name], system="rns")
    jy, _ = jmoe.moe(jp, jnp.asarray(x), n_experts=E, top_k=K,
                     capacity_factor=1.25,
                     dense_kw={"system": "rns", "impl": "ref"})
    ty = moe.moe(tp, torch.from_numpy(x), n_experts=E, top_k=K,
                 capacity_factor=1.25, dense_kw={"system": "rns"})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)


def test_router_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities: ``lax.top_k`` takes
    the lower expert index first, and so must the port."""
    rng = np.random.default_rng(5)
    col = rng.standard_normal(D).astype(np.float32)
    other = rng.standard_normal(D).astype(np.float32)
    w = np.stack([other, col, col, col, other, col], axis=1)   # (D, 6)
    x = _x(6, B=2, S=5)
    _check_routing({"router": {"w": w}}, x, 6, 3, 8.0)
    _, _, idx = moe.route(torch.from_numpy(w),
                          torch.from_numpy(x.reshape(-1, D)), 3)
    # experts {1, 2, 3, 5} tie, and so do {0, 4}: the top 3 are the lowest
    # three of the larger group, or both of {0, 4} then expert 1
    assert {tuple(r) for r in idx.tolist()} <= {(1, 2, 3), (0, 4, 1)}


def test_empty_capacity_rows_quantize_to_zero():
    """Rows of an expert that received no token are all zero: their int4
    codes are zeros (amax clamped at 1e-8) and so is the output row."""
    p = _torch(_params(7))
    w = residency.prepare_weight(p["w_gate"], system="rns")
    x = torch.zeros(E, 8, D)
    x[1, :3] = torch.randn(3, D, generator=torch.Generator().manual_seed(0))
    y = linear.stacked_qmatmul("ecd,edf->ecf", x, w, system="rns")
    assert torch.isfinite(y).all()
    assert not y[0].any() and not y[1, 3:].any() and y[1, :3].any()


def _codes(seed, shape, bound):
    return np.random.default_rng(seed).integers(-bound, bound + 1,
                                                shape).astype(np.int32)


@pytest.mark.parametrize("spec,a_shape", [
    ("ecd,edf->ecf", (4, 5, 40)), ("mk,kn->mn", (5, 40)),
    ("abmk,abkn->abmn", (2, 2, 3, 40))])
def test_einsum_bit_exact_against_reference(spec, a_shape):
    stack = a_shape[:-2]
    w = np.random.default_rng(1).standard_normal(
        (*stack, 40, 24)).astype(np.float32)
    qa = _codes(2, a_shape, 7)
    jt = jnx.encode(jnp.asarray(w), jnx.EncodeSpec(layout="rns",
                                                   mset=jmod.P21, qbits=4))
    tt = nx.encode(torch.from_numpy(w), nx.EncodeSpec(layout="rns",
                                                      mset=P21, qbits=4))
    np.testing.assert_array_equal(tt.planes.numpy(), np.asarray(jt.planes))
    ref = jnx.einsum(spec, jnp.asarray(qa), jt, max_abs_a=7, backend="ref")
    out = nx.einsum(spec, torch.from_numpy(qa), tt, max_abs_a=7)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mset,bound", [(P21, 7), (P21, 127), (P21R2, 7)])
def test_stacked_rns_run_equals_slices(mset, bound):
    """One stacked run against a run per slice: int4 codes (one K segment),
    int8 codes (K 300 cut into three 128-term segments, the same cut for
    every slice) and a redundant set's corrected decode."""
    S, M, Kd, N = 5, 6, 300, 20
    a = torch.from_numpy(_codes(3, (S, M, Kd), bound))
    planes = runners.encode_rns_planes(
        torch.from_numpy(_codes(4, (S, Kd, N), bound)), mset)
    assert runners.segment_count(Kd, bound, bound, mset) >= (3 if bound > 7
                                                             else 1)
    kw = dict(mset=mset, max_abs_a=bound, max_abs_b=bound)
    out = runners.rns_run(a, planes, **kw)
    assert out.shape == (S, M, N)
    for s in range(S):
        torch.testing.assert_close(out[s], runners.rns_run(a[s], planes[s],
                                                           **kw),
                                   rtol=0, atol=0)


def test_einsum_sd_layout_equals_rns():
    """The sd layouts run slice by slice through the SD kernels' plain
    versions: the same integers as the rns stack."""
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 24, 16)).astype(np.float32))
    qa = torch.from_numpy(_codes(9, (3, 4, 24), 7))
    rns = nx.einsum("ecd,edf->ecf", qa,
                    nx.encode(w, nx.EncodeSpec(layout="rns", qbits=4)))
    for layout in ("sd", "sd_matvec"):
        sdt = nx.encode(w, nx.EncodeSpec(layout=layout, qbits=4))
        torch.testing.assert_close(nx.einsum("ecd,edf->ecf", qa, sdt), rns,
                                   rtol=0, atol=0)


BAD_SPECS = ["ecd,edf", "ecd->ecf", "ecd,edf,efg->ecg", "e,e->e",
             "ecd,edf->ec", "ecd,fdf->ecf", "ecd,edf->ecd", "ecd,ecf->ecf",
             "eed,edf->eef", "ecd,edc->ecc"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_einsum_spec_errors_match_reference(spec):
    w = np.ones((2, 8, 4), np.float32)
    a = np.ones((2, 3, 8), np.int32)
    jt = jnx.encode(jnp.asarray(w), jnx.EncodeSpec(layout="rns", qbits=4))
    tt = nx.encode(torch.from_numpy(w), nx.EncodeSpec(layout="rns", qbits=4))
    with pytest.raises(ValueError) as jerr:
        jnx.einsum(spec, jnp.asarray(a), jt, backend="ref")
    with pytest.raises(ValueError) as terr:
        nx.einsum(spec, torch.from_numpy(a), tt)
    assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_einsum_operand_errors():
    w = torch.ones(2, 8, 4)
    t = nx.encode(w, nx.EncodeSpec(layout="rns", qbits=4))
    a = torch.ones(2, 3, 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="ResidueTensor"):
        nx.einsum("ecd,edf->ecf", a, w)
    with pytest.raises(ValueError, match="activation rank"):
        nx.einsum("ecd,edf->ecf", a[0], t)
    with pytest.raises(ValueError, match="encoded operand stack"):
        nx.einsum("mk,kn->mn", a[0], t)
    with pytest.raises(ValueError, match="stack mismatch"):
        nx.einsum("ecd,edf->ecf", torch.ones(3, 3, 8, dtype=torch.int32), t)
    with pytest.raises(ValueError, match="contraction mismatch"):
        nx.einsum("ecd,edf->ecf", torch.ones(2, 3, 7, dtype=torch.int32), t)


def test_stacked_qmatmul_refuses_float_stacks():
    """A float expert stack is refused outside ``rns`` / ``sdrns``; under
    them it takes the per-call path (the training slice), equal to the
    prepared stack's output.  A prepared stack is refused under the other
    number system."""
    w = torch.ones(2, 8, 4)
    x = torch.ones(2, 3, 8)
    with pytest.raises(ValueError, match="unknown system"):
        linear.stacked_qmatmul("ecd,edf->ecf", x, w, system="bns")
    t = residency.prepare_weight(w, system="rns")
    assert torch.equal(
        linear.stacked_qmatmul("ecd,edf->ecf", x, w, system="rns"),
        linear.stacked_qmatmul("ecd,edf->ecf", x, t, system="rns"))
    with pytest.raises(ValueError, match="system 'sdrns'"):
        linear.stacked_qmatmul("ecd,edf->ecf", torch.ones(2, 3, 8), t,
                               system="sdrns")


def test_moe_paged_engine_and_spec_verify():
    """The reduced moonshot on rns8 pages: speculative decoding (its
    batched ``verify_paged``) emits the paged engine's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    model = build_model(cfg, system="rns", device="cpu")
    params = model.prepare_params(model.init(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 10))
    kw = dict(batch=3, s_max=24, page_size=8, kv_format="rns8",
              device="cpu")
    plain = ServingEngine(model, params, **kw).generate(
        {"tokens": prompts}, max_new=8)
    spec = ServingEngine(model, params, spec="ngram:2", **kw).generate(
        {"tokens": prompts}, max_new=8)
    np.testing.assert_array_equal(spec.tokens, plain.tokens)
