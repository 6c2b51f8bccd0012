"""The collectives of the sharded paths, over the axes of a device mesh.

Port-side helper (the reference names ``jax.lax`` collectives inside its
``shard_map`` bodies).  Each function takes the
``torch.distributed.device_mesh.DeviceMesh`` and a tuple of its axis names;
a tuple of several axes runs one collective per axis, ordered so that the
result equals one collective over the axes' flattened group, its blocks
ordered major to minor (the spec order of a tuple entry).

``gloo`` takes CPU tensors only for most collectives, so a CUDA tensor on a
``gloo`` group is staged through host memory (:func:`_staged`); the kernels
keep their operands on the card either way.  ``nccl`` takes it as it is.
An axis of size 1 needs no collective and gets none.

On a :class:`~repro_torch.parallel.sharding.AbstractMesh` (sizes, no ranks:
the dry run) this process is rank 0: :func:`axis_index` is 0 and each
collective returns an empty meta tensor of the shape it would have, moving
nothing.  It takes meta tensors only: a tensor that holds values raises
there, since no other rank's values exist to fill the result.  On either
kind of mesh a collective reports itself, one collective an axis, to the
work count in use (:data:`OBSERVER`), which counts nothing it runs inside
as HBM traffic.

:func:`moved_bytes` counts, per collective, the payload bytes this process
sent or received since :func:`reset_moved_bytes`: an all-gather the blocks
of the other members, an all-reduce its tensor, a reduce-scatter its input,
a broadcast, send or recv its tensor.

The differentiable collectives (:func:`diff_all_gather`,
:func:`diff_all_reduce`, :func:`diff_reduce_scatter`,
:func:`diff_identity`, :func:`diff_slice`) are the training step's: each is
one of the plain collectives (or a local block) with its conjugate as the
backward, for activations that are whole and replicated on every rank of
the axes:

* an all-gather whose consumers are replicated: backward takes the local
  block (``grad="slice"``); of an FSDP weight block over ``dp``, whose
  consumers run on other rows on every rank: backward reduce-scatters,
  summing the gradient over the axes (``grad="sum"``);
* an all-reduce of partial sums: backward is the identity;
* a reduce-scatter onto blocks: backward all-gathers;
* the input of a column-plan product (replicated in, partial gradients
  out): identity forward, all-reduce backward (:func:`diff_identity`);
* a rank's block of a replicated tensor (:func:`diff_slice`): backward
  all-gathers.

Each passes its input through as it is where every axis has size 1.
"""
from __future__ import annotations

from typing import Callable

import contextlib

import torch
import torch.distributed as dist

__all__ = ["axis_index", "axis_size", "all_gather", "all_reduce",
           "reduce_scatter", "broadcast", "send", "recv", "moved_bytes",
           "reset_moved_bytes", "diff_all_gather", "diff_all_reduce",
           "diff_reduce_scatter", "diff_identity", "diff_slice",
           "block_of"]

_MOVED: dict[str, int] = {}


def moved_bytes() -> dict[str, int]:
    """``{collective: payload bytes}`` since the last reset."""
    return dict(_MOVED)


def reset_moved_bytes() -> None:
    _MOVED.clear()


def _count(name: str, nbytes: int) -> None:
    _MOVED[name] = _MOVED.get(name, 0) + nbytes


# the work count in use (``roofline/op_cost.py::OpCost``), or None: called
# as ``OBSERVER(collective, payload bytes, group size)``, it returns a
# context inside which nothing is counted
OBSERVER: Callable | None = None


def _is_abstract(mesh) -> bool:
    return hasattr(mesh, "axis_sizes")


def _abstract(mesh, x: torch.Tensor) -> bool:
    """Whether ``mesh`` is abstract; there ``x`` must be a meta tensor."""
    if not _is_abstract(mesh):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a collective on an AbstractMesh takes meta "
                         f"tensors only (rank 0's program in a dry run); "
                         f"got one on {x.device}")
    return True


def _dim(mesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


def _size(mesh, name: str) -> int:
    if _is_abstract(mesh):
        return mesh.axis_sizes[list(mesh.axis_names).index(name)]
    return mesh.size(_dim(mesh, name))


def axis_size(mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return n


def axis_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's linear index over ``axes``, major to minor (0 on an
    abstract mesh)."""
    if _is_abstract(mesh):
        return 0
    idx = 0
    for a in axes:
        idx = idx * _size(mesh, a) + mesh.get_local_rank(a)
    return idx


@contextlib.contextmanager
def _counted(name: str, out_bytes: int, g: int):
    """Report one collective (its output's bytes, its group's size) to the
    work count in use, and count nothing it runs."""
    if OBSERVER is None:
        yield
        return
    with OBSERVER(name, out_bytes, g):
        yield


def _staged(x: torch.Tensor, group, op: Callable[[torch.Tensor], object]
            ) -> object:
    """``op`` on ``x``, through a host copy when ``group`` is a ``gloo``
    group and ``x`` lies on the card."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return op(x.cpu())
    return op(x)


def _to(out, like: torch.Tensor):
    if isinstance(out, torch.Tensor):
        return out.to(like.device)
    return out


def all_gather(x: torch.Tensor, dim: int, mesh, axes: tuple[str, ...]
               ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``axes`` (the
    minor axis first, so the blocks land major to minor)."""
    for a in reversed(axes):
        n = _size(mesh, a)
        if n == 1:
            continue
        shape = list(x.shape)
        shape[dim] *= n
        with _counted("all-gather", n * x.numel() * x.element_size(), n):
            if _abstract(mesh, x):
                x = x.new_empty(shape)
                continue
            group = mesh.get_group(a)
            _count("all_gather", (n - 1) * x.numel() * x.element_size())

            def op(t, group=group, n=n):
                # gloo: one buffer is faster on dim 0, a list and a cat
                # on the others (no transposing copies)
                t = t.contiguous()
                if dim == 0:
                    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
                    dist.all_gather_into_tensor(out, t, group=group)
                    return out
                bufs = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(bufs, t, group=group)
                return torch.cat(bufs, dim=dim)

            x = _to(_staged(x, group, op), x)
    return x


def all_reduce(x: torch.Tensor, mesh, axes: tuple[str, ...],
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``"max"``) of every rank's ``x`` over ``axes`` (``x``
    itself when every axis has size 1)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in axes:
        n = _size(mesh, a)
        if n == 1:
            continue
        with _counted("all-reduce", x.numel() * x.element_size(), n):
            if _abstract(mesh, x):
                x = x.new_empty(x.shape)
                continue
            group = mesh.get_group(a)
            _count("all_reduce", x.numel() * x.element_size())

            def fn(t, group=group):
                t = t.clone()
                dist.all_reduce(t, op=red, group=group)
                return t

            x = _to(_staged(x, group, fn), x)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes: tuple[str, ...],
                   dim: int = 0) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``x``, cut on ``dim`` into
    ``axis_size`` blocks: this rank keeps block ``axis_index`` (the major
    axis first)."""
    if dim % x.dim():
        return reduce_scatter(x.movedim(dim, 0), mesh, axes).movedim(0, dim)
    for a in axes:
        n = _size(mesh, a)
        if n == 1:
            continue
        shape = (x.shape[0] // n, *x.shape[1:])
        with _counted("reduce-scatter", x.numel() * x.element_size() // n,
                      n):
            if _abstract(mesh, x):
                x = x.new_empty(shape)
                continue
            group = mesh.get_group(a)
            _count("reduce_scatter", x.numel() * x.element_size())

            def fn(t, group=group, n=n):
                t = t.contiguous()
                out = torch.empty((t.shape[0] // n, *t.shape[1:]),
                                  dtype=t.dtype, device=t.device)
                dist.reduce_scatter_tensor(out, t, group=group)
                return out

            x = _to(_staged(x, group, fn), x)
    return x


def _global(mesh, axis: str, index: int) -> int:
    """The global rank of the member at ``index`` on ``axis`` that shares
    this rank's other coordinates."""
    coord = list(mesh.get_coordinate())
    coord[_dim(mesh, axis)] = index
    return int(mesh.mesh[tuple(coord)])


def broadcast(x: torch.Tensor, src: int, mesh, axis: str) -> torch.Tensor:
    """``x`` of the member at index ``src`` on ``axis``, on every member."""
    with _counted("collective-permute", x.numel() * x.element_size(),
                  _size(mesh, axis)):
        if _abstract(mesh, x):
            return x.new_empty(x.shape)
        group = mesh.get_group(axis)
        root = _global(mesh, axis, src)
        _count("broadcast", x.numel() * x.element_size())

        def fn(t):
            t = t.contiguous().clone()
            dist.broadcast(t, src=root, group=group)
            return t

        return _to(_staged(x, group, fn), x)


def send(x: torch.Tensor, dst: int, mesh, axis: str) -> None:
    """Send ``x`` to the member at index ``dst`` on ``axis``."""
    with _counted("collective-permute", x.numel() * x.element_size(),
                  _size(mesh, axis)):
        if _abstract(mesh, x):
            return
        group = mesh.get_group(axis)
        peer = _global(mesh, axis, dst)
        _count("send", x.numel() * x.element_size())
        _staged(x, group, lambda t: dist.send(t.contiguous(), dst=peer,
                                              group=group))


def recv(like: torch.Tensor, src: int, mesh, axis: str) -> torch.Tensor:
    """Receive a tensor shaped like ``like`` from the member at index
    ``src`` on ``axis``."""
    if _abstract(mesh, like):
        return like.new_empty(like.shape)
    group = mesh.get_group(axis)
    peer = _global(mesh, axis, src)
    _count("recv", like.numel() * like.element_size())

    def fn(t):
        buf = torch.empty_like(t)
        dist.recv(buf, src=peer, group=group)
        return buf

    return _to(_staged(like, group, fn), like)


# ---------------------------------------------------------------------------
# Differentiable collectives (module docstring)
# ---------------------------------------------------------------------------


def block_of(x: torch.Tensor, dim: int, mesh, axes: tuple[str, ...]
             ) -> torch.Tensor:
    """This rank's block of ``x`` on ``dim`` split over ``axes`` (a view;
    the major axis first)."""
    n = axis_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


def _trivial(mesh, axes) -> bool:
    return not axes or axis_size(mesh, axes) == 1


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, grad):
        ctx.args = (dim, mesh, axes, grad)
        return all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, grad = ctx.args
        if grad == "sum":
            return reduce_scatter(g, mesh, axes, dim), None, None, None, None
        return block_of(g, dim, mesh, axes).contiguous(), None, None, None, \
            None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes = ctx.args
        return all_gather(g, dim, mesh, axes), None, None, None


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce(g, mesh, axes), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return block_of(x, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes = ctx.args
        return all_gather(g, dim, mesh, axes), None, None, None


def diff_all_gather(x: torch.Tensor, dim: int, mesh, axes: tuple[str, ...],
                    grad: str = "slice") -> torch.Tensor:
    """:func:`all_gather` whose backward takes this rank's block of the
    gradient (``grad="slice"``: the consumers are replicated, so every
    rank holds the whole gradient) or sums it over ``axes`` and keeps the
    block (``grad="sum"``: an FSDP weight block)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', got {grad!r}")
    if _trivial(mesh, axes):
        return x
    return _AllGather.apply(x, dim % x.dim(), mesh, tuple(axes), grad)


def diff_all_reduce(x: torch.Tensor, mesh, axes: tuple[str, ...]
                    ) -> torch.Tensor:
    """The sum of partials over ``axes``; backward the identity."""
    if _trivial(mesh, axes):
        return x
    return _AllReduce.apply(x, mesh, tuple(axes))


def diff_reduce_scatter(x: torch.Tensor, dim: int, mesh,
                        axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of partials over ``axes``, this rank's block on ``dim``;
    backward all-gathers."""
    if _trivial(mesh, axes):
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), mesh, tuple(axes))


def diff_identity(x: torch.Tensor, mesh, axes: tuple[str, ...]
                  ) -> torch.Tensor:
    """``x`` itself; backward sums the gradient over ``axes`` (a
    replicated input whose consumers make partial gradients)."""
    if _trivial(mesh, axes):
        return x
    return _Identity.apply(x, mesh, tuple(axes))


def diff_slice(x: torch.Tensor, dim: int, mesh, axes: tuple[str, ...]
               ) -> torch.Tensor:
    """This rank's block of a replicated ``x`` on ``dim``; backward
    all-gathers the blocks' gradients."""
    if _trivial(mesh, axes):
        return x
    return _Slice.apply(x, dim % x.dim(), mesh, tuple(axes))
