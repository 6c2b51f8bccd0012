"""Checkpoints of prepared (residue-resident) trees in the reference's
layout: each ``ResidueTensor`` as ``<path>/0`` (planes, layers stacked on
axis 0) and ``<path>/1`` (scale).  The reduced qwen3-8b checkpoint's
weights, prepared under ``rns`` and ``sdrns`` by each package, cross the
checkpoint boundary both ways bit for bit, and the restored tree serves
the port's own prepared tree's greedy tokens."""
from __future__ import annotations

import os

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, load_npz
from repro_torch.models.api import build_model
from repro_torch.numerics.tensor import ResidueTensor
from repro_torch.quant import residency
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import checkpoint

from torch_threads import one_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "qwen3-8b", "ckpt_0000000002.npz")


def _flat(tree) -> dict[str, np.ndarray]:
    return {jtu.keystr(p): np.asarray(x)
            for p, x in jtu.tree_flatten_with_path(tree)[0]}


def _npz(directory) -> dict[str, np.ndarray]:
    with np.load(os.path.join(directory, "ckpt_0000000001.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _trees(system):
    np_tree = load_npz(CKPT)
    jmodel = jbuild_model(jget_config("qwen3-8b").reduced(), system=system)
    jprep = jmodel.prepare_params(jtu.tree_map(jnp.asarray, np_tree))
    model = build_model(get_config("qwen3-8b").reduced(), system=system,
                        device="cpu")
    ours = model.prepare_params(from_jax_params(np_tree, model.cfg, "cpu"))
    return jprep, model, ours


def _tokens(model, params, system):
    kw = dict(paged=False) if system == "sdrns" else dict(kv_format="rns8")
    prompts = np.random.default_rng(3).integers(
        0, model.cfg.vocab, (2, 8)).astype(np.int32)
    eng = ServingEngine(model, params, batch=2, s_max=16, page_size=8,
                        device="cpu", **kw)
    return eng.generate({"tokens": prompts}, max_new=4).tokens


@pytest.mark.parametrize("system", ["rns", "sdrns"])
def test_prepared_checkpoints_cross_both_ways(system, tmp_path):
    jprep, model, ours = _trees(system)
    # saved by each package: the same keys and arrays, bit for bit (the
    # two prepare the same planes and scales)
    jckpt.save(str(tmp_path / "ref"), 1, jprep)
    checkpoint.save(str(tmp_path / "port"), 1, ours)
    _assert_flat_equal(_npz(tmp_path / "port"), _npz(tmp_path / "ref"))
    # saved by the reference, restored here
    back = checkpoint.restore(str(tmp_path / "ref"), ours)
    for a, b in zip(residency_leaves(back), residency_leaves(ours)):
        assert (a.mset, a.layout, a.qbits, a.max_abs) == \
            (b.mset, b.layout, b.qbits, b.max_abs)
        assert a.planes.dtype == b.planes.dtype
        assert torch.equal(a.planes, b.planes)
        assert torch.equal(a.scale, b.scale)
    np.testing.assert_array_equal(_tokens(model, back, system),
                                  _tokens(model, ours, system))
    # saved here, restored by the reference
    with np.load(os.path.join(tmp_path / "port",
                              "ckpt_0000000001.npz")) as z:
        assert "layers/attn/wq/w/0" in z.files
        assert "layers/attn/wq/w/1" in z.files
        assert z["layers/attn/wq/w/0"].shape[0] == model.cfg.n_layers
    jback = jckpt.restore(str(tmp_path / "port"), jprep)
    _assert_flat_equal(_flat(jback), _flat(jprep))


def residency_leaves(tree) -> list[ResidueTensor]:
    out: list[ResidueTensor] = []
    residency.map_resident(tree, out.append)
    assert out
    return out


def test_prepared_restore_keeps_the_kind_guard(tmp_path):
    """Planes are exact integer encodings: a float template under them is a
    structure mismatch, and the metadata comes from the template."""
    t = residency.prepare_weight(torch.randn(8, 4), system="rns")
    checkpoint.save(str(tmp_path), 1, {"w": t})
    back = checkpoint.restore(str(tmp_path), {"w": t})["w"]
    assert torch.equal(back.planes, t.planes) and back.mset == t.mset
    bad = ResidueTensor(t.planes.float(), t.scale, t.mset, t.layout,
                        t.qbits, t.max_abs)
    with pytest.raises(ValueError, match="dtype-kind"):
        checkpoint.restore(str(tmp_path), {"w": bad})
