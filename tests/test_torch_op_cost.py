"""The work counter's byte model (``roofline/op_cost.py::moved_bytes``), its
hook into the kernel registry and the collectives, and rank 0's program on
an ``AbstractMesh`` taking meta tensors only."""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import build_model
from repro_torch.numerics import attention as nxattn
from repro_torch.numerics import registry
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as tsh
from repro_torch.roofline import op_cost

from torch_threads import one_thread  # noqa: F401

DEVICES = ["cpu", "meta"]
F32 = 4


def _bytes_of(fn, name):
    with op_cost.OpCost() as c:
        fn()
    return c.by_op[f"aten.{name}"]["bytes"]


@pytest.mark.parametrize("device", DEVICES)
def test_gathers_count_the_rows_they_read(device):
    """A gather reads its result's rows and its indices, not the table."""
    table = torch.empty((1000, 64), device=device)
    idx = torch.zeros(8, dtype=torch.int64, device=device)
    rows = 8 * 64 * F32
    want = 2 * rows + 8 * 8
    assert _bytes_of(lambda: torch.nn.functional.embedding(idx, table),
                     "embedding") == want
    assert _bytes_of(lambda: table[idx], "index") == want
    assert _bytes_of(lambda: table.index_select(0, idx),
                     "index_select") == want


@pytest.mark.parametrize("device", DEVICES)
def test_written_operand_is_read_only_where_the_op_reads_it(device):
    """``copy_`` and ``fill_`` overwrite without reading; ``add_`` reads
    what it writes; an ``out=`` operand is written, not read; the aliased
    result is the one write."""
    a, b, c = (torch.empty((32, 64), device=device) for _ in range(3))
    n = 32 * 64 * F32
    assert _bytes_of(lambda: a.copy_(b), "copy_") == 2 * n
    assert _bytes_of(lambda: a.fill_(1.0), "fill_") == n
    assert _bytes_of(lambda: a.zero_(), "zero_") == n
    assert _bytes_of(lambda: a.add_(b), "add_") == 3 * n
    assert _bytes_of(lambda: torch.add(a, b, out=c), "add") == 3 * n
    # a copy into a row of a larger tensor writes the row
    assert _bytes_of(lambda: a[3].copy_(b[0]), "copy_") == 2 * 64 * F32


@pytest.mark.parametrize("device", DEVICES)
def test_views_count_the_elements_they_hold(device):
    """An expanded operand counts the elements it stores, a strided view
    the elements it spans; a ``*_like`` op reads no operand."""
    row = torch.empty((1, 64), device=device)
    x = torch.empty((32, 64), device=device)
    n = 32 * 64 * F32
    assert _bytes_of(lambda: row.expand(32, 64) + x, "add") == \
        64 * F32 + 2 * n
    assert _bytes_of(lambda: x[:, ::2] * 2.0, "mul") == 2 * (n // 2)
    assert _bytes_of(lambda: torch.zeros_like(x), "zeros_like") == n


def test_registry_hands_out_the_implementation_outside_a_count():
    impls = registry._REGISTRY["rns_matmul"]
    assert registry.get_impl("rns_matmul", "cpu") is impls["ref"]
    assert registry.get_impl("rns_matmul", "meta") is impls["meta"]
    with op_cost.OpCost() as outer:
        assert registry.OBSERVER == outer.kernel
        assert collectives.OBSERVER == outer.collective
        with op_cost.OpCost() as inner:
            assert registry.OBSERVER == inner.kernel
        assert registry.OBSERVER == outer.kernel
    assert registry.OBSERVER is None and collectives.OBSERVER is None
    assert registry.get_impl("rns_matmul", "cpu") is impls["ref"]


def test_lower_layers_do_not_import_the_analysis_layer():
    src = pathlib.Path(nxattn.__file__).parents[1]
    for layer in ("numerics", "parallel", "kernels", "models"):
        for f in sorted((src / layer).glob("*.py")):
            assert not re.search(r"^\s*(from|import) repro_torch\.roofline"
                                 r"|^\s*from repro_torch import .*roofline",
                                 f.read_text(), re.M), f


def _residues(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _residues(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _residues(v)]
    return [tree] if hasattr(tree, "sharding") else []


def test_abstract_mesh_takes_meta_tensors_only():
    """Rank 0's program on an AbstractMesh has shapes and no values: a
    tensor that holds values raises, where an empty result would pass."""
    mesh = tsh.AbstractMesh((2, 2), ("data", "model"))
    meta = torch.empty((4, 6), device="meta")
    assert collectives.all_gather(meta, 0, mesh, ("model",)).shape == (8, 6)
    assert collectives.all_reduce(meta, mesh, ("model",)).shape == (4, 6)
    assert collectives.reduce_scatter(meta, mesh, ("model",)).shape == \
        (2, 6)
    cpu = torch.zeros((4, 6))
    for call in (lambda: collectives.all_gather(cpu, 0, mesh, ("model",)),
                 lambda: collectives.all_reduce(cpu, mesh, ("model",)),
                 lambda: collectives.reduce_scatter(cpu, mesh, ("model",)),
                 lambda: collectives.broadcast(cpu, 0, mesh, "model"),
                 lambda: collectives.recv(cpu, 0, mesh, "model")):
        with pytest.raises(ValueError, match="meta"):
            call()

    cfg = get_config("qwen3-8b").reduced()
    ctx = tmesh.make_ctx(mesh)
    tree = build_model(cfg, system="rns", device="cpu").init(0)
    with pytest.raises(ValueError, match="no ranks"):
        tsh.shard_params(tree, ctx)
    meta_tree = build_model(cfg, system="rns", device="meta").init(0)
    placed = _residues(tsh.shard_params(meta_tree, ctx))
    assert placed and all(t.sharding is not None and t.planes.is_meta
                          for t in placed)


@pytest.mark.parametrize("device", DEVICES)
def test_flash_decode_length_as_int(device):
    """One length for every slot as an int gives the tensor form's output
    and the same count."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((3, 4, 8), (3, 16, 2, 8), (3, 16, 2, 8)))
    if device == "meta":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with op_cost.OpCost() as as_int:
        out = nxattn.flash_decode(q, k, v, kv_len=5)
    lens = torch.full((3,), 5, dtype=torch.int32,
                      device="cpu" if device == "meta" else device)
    with op_cost.OpCost() as as_tensor:
        want = nxattn.flash_decode(q, k, v, kv_len=lens)
    assert as_int.by_op["flash_decode"] == as_tensor.by_op["flash_decode"]
    assert as_int.launches == {"flash_decode": 1}
    assert out.shape == want.shape == (3, 4, 8)
    if device == "cpu":
        assert torch.equal(out, want)
