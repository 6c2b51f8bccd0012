"""Shared check of ``tests/test_torch_train_families.py``,
``tests/test_torch_train_families_ssm.py`` and
``tests/test_torch_train_grok.py``: ``Model.loss``, its gradients and one
AdamW step of the port against the JAX package, one family at its reduced
shapes.

Each reduced model has random weights from ``jax.random.PRNGKey(0)``,
carried into the port through ``convert.from_jax_params`` (bf16 for grok's
``param_dtype``).  The reference's loss is differentiated with
``jax.value_and_grad`` (its residue matmuls on the exact ``ref`` backend,
its attention on the materialized path its training takes).  Its layer
scans compile their bodies, and compiled, its quantizer's ``amax / qmax``
becomes a multiply by the reciprocal, one ulp off.  On f32 weights and
activations no int4 code sits on an exact rounding tie, so that ulp moves
nothing; grok's bf16 weights sit on ties often enough that whole weights'
codes would differ, so grok's reference under ``rns`` runs under
``jax.disable_jit()``, its functions stepped eagerly.  Its bf16 embedding
rows also put first-layer int4 codes on exact ties, where XLA's and
PyTorch's RMSNorm differ by an ulp (``test_torch_model_families.py``), so
its batch is drawn from the tie-free rows.

Limits: the loss within 1e-5 relative; gradients, parameters and moments
after one AdamW step within the reference's own ``rtol=2e-4, atol=2e-5``
(``tests/test_data_and_loop.py``).  grok-1-314b keeps its parameters and
gradients in bf16, so its limit is two bf16 roundings (``rtol=2**-6``):
both packages sum in f32 in another order and round to bf16, and the tied
table's gradient is then the bf16 sum of its embedding and its logits
cotangents, each rounded.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_update as jadamw
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.train.loop import loss_and_grads
from repro_torch.train.optimizer import OptConfig, adamw_update, \
    init_opt_state
from repro_torch.train.tree import tree_map

B, S, FRAMES = 4, 8, 12
OPT = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This module's ops are small: on a loaded CPU (parallel test workers)
    the intra-op thread pool's barriers cost more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, tree):
    rng = np.random.default_rng(1)
    b = TokenPipeline(cfg.vocab, S, B, seed=1).batch_at(0)
    if cfg.name == "grok-1-314b":
        x64 = np.asarray(tree["embed"]["table"]).astype(np.float64)
        exact = 7 * x64 / np.abs(x64).max(-1, keepdims=True)
        free = np.flatnonzero(~(np.abs(exact - np.floor(exact)) == 0.5
                                ).any(-1))
        b = {k: rng.choice(free, (B, S)).astype(np.int32) for k in b}
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        b["patches"] = (rng.normal(size=(B, n, cfg.d_model)) * 0.02
                        ).astype(np.float32)
        b["labels"] = np.concatenate(
            [np.full((B, n), -1, np.int32), b["labels"]], axis=1)
    if cfg.is_encdec:
        b["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(
            np.float32)
    return b


def _close(got, want, rtol, atol, what):
    flat = jtu.tree_flatten_with_path(want)[0]
    for path, w in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol,
                                   err_msg=f"{what} {jtu.keystr(path)}")
    return len(flat)


def check_family(arch: str, system: str) -> None:
    cfg = get_config(arch).reduced()
    jm = jbuild_model(jget_config(arch).reduced(), system=system,
                      rns_impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jtu.tree_map(np.asarray, jp)
    batch = _batch(cfg, tree)
    jocfg = JOptConfig(**OPT, moment_dtype=cfg.opt_state_dtype)
    bf16 = cfg.param_dtype == "bfloat16"
    with jax.disable_jit(bf16 and system != "bns"):
        (jl, jce), jg = jax.value_and_grad(jm.loss, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jp2, jst, jmet = jax.jit(jadamw, static_argnums=3)(
        jp, jg, jinit_opt(jp, jocfg), jocfg)

    model = build_model(cfg, system=system, device="cpu")
    pd = getattr(torch, cfg.param_dtype)
    tp = tree_map(lambda x: x.to(pd), from_jax_params(tree, cfg, "cpu"))
    (tl, tce), tg = loss_and_grads(model, tp, batch)
    ocfg = OptConfig(**OPT, moment_dtype=cfg.opt_state_dtype)
    tp2, tst, tmet = adamw_update(tp, tg, init_opt_state(tp, ocfg), ocfg)

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tce), float(jce), rtol=1e-5)
    rtol, atol = (2.0 ** -6, 2e-5) if bf16 else (2e-4, 2e-5)
    n = _close(to_jax_params(tg), jg, rtol, atol, "grad")
    assert n == len(jtu.tree_leaves(jp))
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    _close(to_jax_params(tp2), jp2, rtol, atol, "param after one step")
    _close(to_jax_params(tst["m"]), jst["m"], rtol, atol, "m")
    _close(to_jax_params(tst["v"]), jst["v"], rtol, atol, "v")
    assert int(tst["step"]) == int(jst["step"]) == 1
