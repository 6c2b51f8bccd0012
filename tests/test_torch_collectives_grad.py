"""The differentiable collectives of ``parallel/collectives.py`` on a (2, 2)
gloo group: each one's forward and backward equal autograd of the same
computation done whole in one process.

A rank's output and input gradient are those of one member of a logical
computation over its group (the ranks along the axes, one axis or both):

* ``diff_all_gather`` with ``grad="slice"`` and ``diff_all_reduce`` feed
  one replicated consumer (every member holds the same cotangent, counted
  once);
* ``diff_all_gather`` with ``grad="sum"`` (an FSDP block) and
  ``diff_reduce_scatter`` feed one consumer a member, each its own
  cotangent;
* ``diff_identity`` and ``diff_slice`` take one replicated input (every
  member holds the same values) into one consumer a member.

The whole computation is written with ``torch.cat`` / sums / slices over
the group's members and differentiated by autograd; the ranks' outputs and
gradients must equal it within f32 rounding of the sums' order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_mesh
from torch_mesh import COLL_GROUPS
from torch_threads import one_thread  # noqa: F401

NAMES = ("gather_slice", "gather_sum", "all_reduce", "reduce_scatter",
         "identity", "slice")
CASES = [(n, a) for n in NAMES for a in COLL_GROUPS]
REPLICATED_IN = ("identity", "slice")         # one input on every member
REPLICATED_OUT = ("gather_slice", "all_reduce")  # one consumer


def _shapes(name: str, n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(input, output) shapes of one member for a group of n."""
    x = (3, 4 * n) if name in ("reduce_scatter", "slice") else (3, 4)
    y = {"gather_slice": (3, 4 * n), "gather_sum": (3, 4 * n),
         "reduce_scatter": (3, 4), "slice": (3, 4)}.get(name, x)
    return x, y


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    inputs, cots = {}, {}
    for name, axes in CASES:
        groups = COLL_GROUPS[axes]
        xs, cs = [None] * 4, [None] * 4
        for g in groups:
            xshape, yshape = _shapes(name, len(g))
            shared_x = rng.normal(size=xshape).astype(np.float32)
            shared_c = rng.normal(size=yshape).astype(np.float32)
            for r in g:
                xs[r] = shared_x if name in REPLICATED_IN else \
                    rng.normal(size=xshape).astype(np.float32)
                cs[r] = shared_c if name in REPLICATED_OUT else \
                    rng.normal(size=yshape).astype(np.float32)
        inputs[(name, axes)], cots[(name, axes)] = xs, cs
    return inputs, cots


def _whole(name, xs, cs):
    """Outputs and input gradients of one group's logical computation
    (members in group order), by autograd in this process."""
    n = len(xs)
    if name in REPLICATED_IN:
        x = torch.as_tensor(xs[0]).requires_grad_(True)
        leaves = [x]
    else:
        leaves = [torch.as_tensor(v).requires_grad_(True) for v in xs]
    cs = [torch.as_tensor(c) for c in cs]
    if name in ("gather_slice", "gather_sum"):
        outs = [torch.cat(leaves, dim=1)] * n
    elif name == "all_reduce":
        outs = [sum(leaves)] * n
    elif name == "reduce_scatter":
        outs = list(torch.chunk(sum(leaves), n, dim=1))
    elif name == "identity":
        outs = [x] * n
    else:
        outs = list(torch.chunk(x, n, dim=1))
    if name in REPLICATED_OUT:
        loss = (outs[0] * cs[0]).sum()
    else:
        loss = sum((o * c).sum() for o, c in zip(outs, cs))
    grads = torch.autograd.grad(loss, leaves)
    if name in REPLICATED_IN:
        grads = grads * n
    return [o.detach() for o in outs], list(grads)


@pytest.fixture(scope="module")
def coll_run(tmp_path_factory):
    inputs, cots = _inputs()
    run = torch_mesh.RankRun(torch_mesh.coll_grad_body, 4,
                             tmp_path_factory.mktemp("coll_grad"), inputs,
                             cots)
    return run.results(), inputs, cots


@pytest.mark.parametrize("name,axes", CASES)
def test_forward_and_backward_equal_whole(coll_run, name, axes):
    ranks, inputs, cots = coll_run
    for group in COLL_GROUPS[axes]:
        order = sorted(group, key=lambda r: ranks[r][(name, axes)][2])
        outs, grads = _whole(name, [inputs[(name, axes)][r] for r in order],
                             [cots[(name, axes)][r] for r in order])
        for i, r in enumerate(order):
            y, gx, idx = ranks[r][(name, axes)]
            assert idx == i
            np.testing.assert_allclose(y.numpy(), outs[i].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {axes} rank {r}")
            np.testing.assert_allclose(gx.numpy(), grads[i].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {axes} rank {r}")


def test_group_order_is_major_to_minor(coll_run):
    """Over both axes a rank's index is data * 2 + model: its global rank
    on the row-major (2, 2) mesh."""
    ranks, _, _ = coll_run
    assert [ranks[r][("slice", ("data", "model"))][2] for r in range(4)] \
        == [0, 1, 2, 3]
    assert [ranks[r][("slice", ("data",))][2] for r in range(4)] \
        == [0, 0, 1, 1]


def test_size_one_axes_pass_through():
    """An axis of size 1 needs no collective: the input comes back as it
    is, with no process group."""
    from repro_torch.parallel import collectives as c
    from repro_torch.parallel.sharding import AbstractMesh

    mesh = AbstractMesh((1, 4), ("data", "model"))
    x = torch.ones(2, 3)
    for fn in (lambda: c.diff_all_gather(x, 1, mesh, ("data",)),
               lambda: c.diff_all_reduce(x, mesh, ("data",)),
               lambda: c.diff_reduce_scatter(x, 1, mesh, ("data",)),
               lambda: c.diff_identity(x, mesh, ("data",)),
               lambda: c.diff_slice(x, 1, mesh, ("data",))):
        assert fn() is x
    with pytest.raises(ValueError, match="grad"):
        c.diff_all_gather(x, 0, mesh, ("model",), grad="mean")


def test_meta_on_an_abstract_mesh():
    """On an AbstractMesh (the dry run: rank 0, shapes only) each
    collective gives the shape it would have, forward and backward."""
    from repro_torch.parallel import collectives as c
    from repro_torch.parallel.sharding import AbstractMesh

    mesh = AbstractMesh((2, 4), ("data", "model"))
    x = torch.empty(2, 8, device="meta", requires_grad=True)
    y = c.diff_all_gather(x, 1, mesh, ("model",), "sum")
    assert y.shape == (2, 32) and y.is_meta
    (g,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert g.shape == x.shape
    z = c.diff_reduce_scatter(x, 1, mesh, ("model",))
    assert z.shape == (2, 2)
    (g,) = torch.autograd.grad(z, x, torch.empty_like(z))
    assert g.shape == x.shape
    s = c.diff_slice(x, 1, mesh, ("data", "model"))
    assert s.shape == (2, 1)


def test_remat_recomputes_under_the_forward_shard_ctx():
    """A remat'd layer recomputes in the backward under the shard context
    it ran under, also where the backward runs on another thread (the
    autograd engine's own thread on the card), which does not see the
    caller's context variables."""
    import threading

    from repro_torch.models.layers import remat_call
    from repro_torch.parallel.sharding import (AbstractMesh, ShardCtx,
                                               get_shard_ctx, shard_ctx)

    def fn(x):          # the product saves its operands for the backward
        return x * (x if get_shard_ctx() is not None else x + 1)

    x = torch.full((4,), 3.0, requires_grad=True)
    with shard_ctx(ShardCtx(AbstractMesh((1, 2), ("data", "model")))):
        y = remat_call(True, fn, x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert torch.equal(x.grad, torch.full((4,), 6.0))      # d(x^2) = 2x
