"""Sharding rules, specs and the shard context (port of
``repro/parallel/sharding.py``).

* :class:`ShardCtx` -- the mesh and the axis names of the roles: ``"dp"``
  (batch and FSDP axes), ``"tp"`` (tensor axes); ``"seq"`` resolves to the
  tensor axes under ``seq_shard`` (Megatron-SP in the training forward,
  ``models/transformer.py``), else to none.  Launchers install it
  with :func:`shard_ctx`;
  the planners read it with :func:`get_shard_ctx`.  With no context every
  path runs on one device.
* :func:`param_specs` -- name-based specs of a parameter tree: FSDP over
  ``dp`` on the non-TP dim, TP over ``tp`` on heads / ffn / vocab / experts.
  A :class:`~repro_torch.numerics.tensor.ResidueTensor` is one typed leaf:
  the rule fires on its represented ``(*stack, K, N)`` value and
  ``ResidueTensor.leaf_roles`` maps it onto the planes and the scale (TP
  on N, or the moduli-channel axis C under ``channel_shard``).  Every
  request that does not divide its dim is dropped (replicated), never an
  error.
* :func:`shard_params` / :func:`shard_residue_tensor` -- keep this rank's
  block of each resident weight and record where it sits
  (:class:`ResidueSharding`, the counterpart of the reference's
  ``NamedSharding``).  On an :class:`AbstractMesh` this process is rank 0
  (the dry run costs rank 0's program): its blocks, on the meta device in
  the dry run.
* :func:`place_tree` / :func:`gather_tree` -- a float tree (a train
  state's parameters, ``m`` and ``v``) as this rank's blocks on its
  :func:`param_specs` specs, and back whole; :class:`ShardedParam` is
  such a block in the training forward, which the model code gathers and
  multiplies by the plans its spec implies (``models/linear.py``).

The port runs explicit SPMD over ``torch.distributed``: one process a rank,
each holding its block of every sharded leaf, and every sharded op a
per-rank body with named collectives (``parallel/collectives.py``), as the
reference's ``shard_map`` bodies are.  There is no GSPMD propagation, so
the reference's layout hints (``constrain``) have no counterpart: a layout
is the runner's.  Serving, activations between ops are whole on every
rank; the runners (``numerics/runners.py``) and the attention dispatchers
(``numerics/attention.py``) take their rows over ``dp`` and their columns
or channels over ``tp`` and gather the result, and the float leaves (the
embedding table the gather reads, the norms, the moe router) stay whole on
every rank.  Training (``train/loop.py``), each ``dp`` rank holds its own
rows (``ShardCtx.rows_local``: the planners split no rows again) and
every float leaf as its block; activations are whole over ``tp`` (on
sequence shards between the matmul blocks under ``seq_shard``).

A spec (:class:`Spec`) is a tuple of entries ``None``, an axis name or a
tuple of names, as a ``PartitionSpec`` is.  ``ShardCtx.mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or an
:class:`AbstractMesh` (names and sizes only): specs and plans need only the
sizes; placing a block needs a rank (rank 0 on an abstract mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from contextvars import ContextVar
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.parallel import collectives
from repro_torch.train.tree import tree_map

__all__ = ["Spec", "AbstractMesh", "mesh_shape", "Roles", "ShardCtx",
           "shard_ctx", "get_shard_ctx", "param_specs", "rule_roles", "batch_spec_train",
           "logical_to_spec", "ResidueSpecs", "residue_specs",
           "specs_from_roles", "ResidueSharding", "shard_residue_tensor",
           "shard_params", "unshard_residue_tensor", "relayout",
           "spec_axes", "ShardedParam", "place_tree",
           "gather_tree", "spec_axes_of", "dp_rows"]


class Spec(tuple):
    """A sharding spec: one entry a dim, ``None`` (replicated), an axis
    name, or a tuple of names (the dim split over their product, major to
    minor); a tuple of one name is that name, as in a ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes with sizes and no ranks (specs and plans)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _is_residue(x) -> bool:
    from repro_torch.numerics.tensor import ResidueTensor

    return isinstance(x, ResidueTensor)


@dataclasses.dataclass(frozen=True)
class Roles:
    """A tuple of roles for one tensor (a leaf of a roles tree)."""

    roles: tuple

    @staticmethod
    def of(*roles) -> "Roles":
        return Roles(tuple(roles))


_CTX: ContextVar["ShardCtx | None"] = ContextVar("repro_torch_shard_ctx",
                                                 default=None)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Any
    dp: tuple[str, ...] = ("data",)   # batch / FSDP axes
    tp: tuple[str, ...] = ("model",)  # tensor axes
    # Split the moduli-channel axis C of residue planes over tp (the
    # paper's channel parallelism) instead of the default TP-on-N layout.
    # The matmuls then take the partial-CRT all-reduce schedule; when it
    # cannot (C % tp_size, no moduli set, a set past the int32 bound) the
    # planner warns and counts a fallback (runners.fallback_gather_count).
    channel_shard: bool = False
    # SP: the training forward's norms and residual adds run on sequence
    # shards over tp (``resolve("seq")`` is then the tensor axes)
    seq_shard: bool = False
    # the activations' rows are this rank's block over dp already (the
    # train step): the planners split no rows over dp
    rows_local: bool = False

    def axis_size(self, roles) -> int:
        shape = mesh_shape(self.mesh)
        out = 1
        for n in self.resolve(roles):
            out *= shape[n]
        return out

    def resolve(self, role) -> tuple[str, ...]:
        """``"dp"`` / ``"tp"`` / ``"seq"`` / an axis name / a tuple of them
        -> mesh axis names (``"seq"``: the tensor axes under
        ``seq_shard``, else none)."""
        if role is None:
            return ()
        if isinstance(role, str):
            if role == "dp":
                return self.dp
            if role == "tp":
                return self.tp
            if role == "seq":
                return self.tp if self.seq_shard else ()
            return (role,)
        out: list[str] = []
        for r in role:
            out.extend(self.resolve(r))
        return tuple(out)


@contextlib.contextmanager
def shard_ctx(ctx: ShardCtx | None):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def get_shard_ctx() -> ShardCtx | None:
    return _CTX.get()


def _fit_spec(ctx: ShardCtx, shape: Sequence[int], roles: Sequence) -> Spec:
    """A spec from roles, dropping the axes that do not divide the dim."""
    sizes = mesh_shape(ctx.mesh)
    spec: list[Any] = []
    for dim, role in zip(shape, roles):
        keep: list[str] = []
        size = dim
        for n in ctx.resolve(role):
            if size % sizes[n] == 0:
                keep.append(n)
                size //= sizes[n]
        spec.append(None if not keep else keep[0] if len(keep) == 1
                    else tuple(keep))
    return Spec(*spec)


# ---------------------------------------------------------------------------
# Parameter rules (name-based): column-parallel weights (d_model -> wide) are
# (dp, tp), row-parallel ones (wide -> d_model) (tp, dp); a stacked leaf
# carries a leading None; an expert stack shards its expert dim over tp when
# it divides (EP), else TP inside each expert.
# ---------------------------------------------------------------------------

_COL = re.compile(r"^(wq|wk|wv|w_gate|w_up|in_proj|router)$")
_ROW = re.compile(r"^(wo|w_down|out_proj)$")
STACKED_PREFIXES = ("layers", "enc_layers", "dec_layers", "groups", "tail")


def _leaf_roles(path_names: list[str], shape: tuple[int, ...], *,
                stacked: bool, n_experts_tp: bool) -> list:
    """Roles (one a dim) of one parameter leaf."""
    names = set(path_names)
    lead: list = [None] if stacked else []
    body = shape[1:] if stacked else shape

    def wrap(roles: list) -> list:
        return lead + roles

    if "table" in names:                       # embeddings (vocab, d)
        return wrap(["tp", "dp"])
    if len(body) == 3 and any(n in names for n in ("w_gate", "w_up",
                                                   "w_down")):
        if n_experts_tp:                       # experts (E, d_in, d_out)
            return wrap(["tp", "dp", None])
        if any(n in names for n in ("w_gate", "w_up")):
            return wrap([None, "dp", "tp"])
        return wrap([None, "tp", "dp"])
    if len(body) == 2:                         # dense weights
        parent = path_names[-2] if len(path_names) >= 2 else ""
        key = parent if path_names[-1] == "w" else path_names[-1]
        if _COL.match(key):
            return wrap(["dp", "tp"])
        if _ROW.match(key):
            return wrap(["tp", "dp"])
        if key == "conv_w":
            return wrap([None, "tp"])
        return wrap(["dp", "tp"])              # FSDP in, TP out
    return wrap([None] * len(body))            # vectors / scalars


def rule_roles(path_names: Sequence[str], shape: Sequence[int],
               tp_size: int, *, in_list: bool = False,
               stacked_prefixes: tuple[str, ...] = STACKED_PREFIXES,
               expert_axis_ok: bool | None = None) -> list:
    """The name rule's roles for the leaf at ``path_names``.

    A leaf under a stacked prefix carries a leading layer axis in the
    reference's trees; the port keeps its layers as a list of per-layer
    trees, and a leaf reached through that list (``in_list``) has no
    stack axis.  EP (the expert axis over tp) applies where ``E % tp_size
    == 0`` unless ``expert_axis_ok`` forces it.
    """
    pn = [str(p) for p in path_names]
    shape = tuple(shape)
    stacked = (bool(pn) and pn[0] in stacked_prefixes and not in_list
               and len(shape) >= 1)
    ep = expert_axis_ok
    if ep is None:
        body = shape[1:] if stacked else shape
        ep = len(body) == 3 and body[0] % tp_size == 0
    return _leaf_roles(pn, shape, stacked=stacked, n_experts_tp=ep)


class ResidueSpecs(NamedTuple):
    """The specs of one ResidueTensor's planes and scale."""
    planes: Spec
    scale: Spec | None


def residue_specs(t: Any, value_roles: Sequence, ctx: ShardCtx
                  ) -> ResidueSpecs:
    """Specs of a :class:`ResidueTensor`'s planes and scale from roles of
    its represented ``(*stack, K, N)`` value (``leaf_roles`` maps them; the
    C axis takes ``tp`` under ``ctx.channel_shard``)."""
    channel_role = "tp" if ctx.channel_shard else None
    planes_roles, scale_roles = t.leaf_roles(value_roles,
                                             channel_role=channel_role)
    planes_shape, scale_shape = t.whole_shapes()
    return ResidueSpecs(
        _fit_spec(ctx, planes_shape, planes_roles),
        None if scale_shape is None else _fit_spec(ctx, scale_shape,
                                                    scale_roles))


def _tree_map(fn, tree, path: tuple = (), in_list: bool = False):
    """``fn(path, leaf, in_list)`` over dicts, lists and tuples (named
    tuples keep their type); a ResidueTensor is one leaf."""
    if _is_residue(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(path, tree, in_list)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,), in_list)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, path + (str(i),), True)
                for i, v in enumerate(tree)]
    items = [_tree_map(fn, v, path + (str(i),), in_list)
             for i, v in enumerate(tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def param_specs(shapes: Any, ctx: ShardCtx, *,
                stacked_prefixes: tuple[str, ...] = STACKED_PREFIXES,
                expert_axis_ok: bool | None = None) -> Any:
    """Specs of a parameter tree (tensors, ResidueTensors, or anything with
    a ``.shape``): the tree's structure with a :class:`Spec` at each plain
    leaf and :class:`ResidueSpecs` at each ResidueTensor."""
    tp_size = ctx.axis_size("tp")

    def rule(path, leaf, in_list):
        roles = rule_roles(path, leaf.shape, tp_size, in_list=in_list,
                           stacked_prefixes=stacked_prefixes,
                           expert_axis_ok=expert_axis_ok)
        if _is_residue(leaf):
            return residue_specs(leaf, roles, ctx)
        return _fit_spec(ctx, tuple(leaf.shape), roles)

    return _tree_map(rule, shapes)


def batch_spec_train(ctx: ShardCtx) -> Spec:
    """(B, S) token batches: batch over every dp axis."""
    return Spec(tuple(ctx.dp))


def logical_to_spec(ctx: ShardCtx, shape: Sequence[int], roles: Sequence
                    ) -> Spec:
    return _fit_spec(ctx, shape, roles)


def specs_from_roles(shapes: Any, roles: Any, ctx: ShardCtx) -> Any:
    """Specs from a shape tree and a matching tree of :class:`Roles` (one
    entry a ResidueTensor, against its represented value)."""
    def one(s, r):
        if _is_residue(s):
            return residue_specs(s, r.roles, ctx)
        return _fit_spec(ctx, tuple(s.shape), r.roles)

    if _is_residue(shapes) or not isinstance(shapes, (dict, list, tuple)):
        return one(shapes, roles)
    if isinstance(shapes, dict):
        return {k: specs_from_roles(v, roles[k], ctx)
                for k, v in shapes.items()}
    items = [specs_from_roles(v, r, ctx) for v, r in zip(shapes, roles)]
    if isinstance(shapes, list):
        return items
    return type(shapes)(*items) if hasattr(shapes, "_fields") \
        else tuple(items)


# ---------------------------------------------------------------------------
# Placement: each rank keeps its block.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResidueSharding:
    """Where a sharded ResidueTensor's local planes and scale sit: their
    specs on ``ctx.mesh`` and the whole tensors' shapes."""

    ctx: ShardCtx
    planes: Spec
    scale: Spec | None
    planes_shape: tuple[int, ...]
    scale_shape: tuple[int, ...] | None


def _check_ranked(ctx: ShardCtx, x: torch.Tensor) -> None:
    if isinstance(ctx.mesh, AbstractMesh):
        if x.device.type != "meta":     # rank 0's blocks, shapes only
            raise ValueError("an AbstractMesh has no ranks: it places "
                             "blocks of meta tensors only (rank 0's "
                             "program in a dry run); place blocks of a "
                             "tensor on a DeviceMesh")
        return
    if ctx.mesh.get_coordinate() is None:
        raise ValueError("this rank is not a member of the context's mesh")


def relayout(x: torch.Tensor, mesh, have: Sequence, want: Sequence
             ) -> torch.Tensor:
    """This rank's block of ``want`` from its block of ``have`` (two specs
    of one tensor): every dim whose entries differ is gathered whole, then
    cut as ``want`` says.  Returns ``x`` itself when the specs agree."""
    have = [spec_axes(e) for e in have]
    want = [spec_axes(e) for e in want]
    for d, (h, w) in enumerate(zip(have, want)):
        if h != w and h:
            x = collectives.all_gather(x, d, mesh, h)
    for d, (h, w) in enumerate(zip(have, want)):
        if h != w and w:
            x = collectives.block_of(x, d, mesh, w)
    return x


def _own(x: torch.Tensor) -> torch.Tensor:
    """A compact copy of a block (a narrowed view keeps its whole storage
    alive)."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


def shard_residue_tensor(t: Any, value_roles: Sequence, ctx: ShardCtx
                         ) -> Any:
    """This rank's block of one ResidueTensor on its role-derived specs,
    with its :class:`ResidueSharding` recorded.  A tensor already sharded
    is re-laid from its blocks."""
    _check_ranked(ctx, t.planes)
    specs = residue_specs(t, value_roles, ctx)
    planes_shape, scale_shape = t.whole_shapes()
    mesh = ctx.mesh
    if t.sharding is not None:
        if t.sharding.ctx.mesh is not mesh:
            t = unshard_residue_tensor(t)
        elif (t.sharding.planes, t.sharding.scale) == tuple(specs):
            return dataclasses.replace(t, sharding=dataclasses.replace(
                t.sharding, ctx=ctx))
    have_p = t.sharding.planes if t.sharding else (None,) * len(planes_shape)
    planes = _own(relayout(t.planes, mesh, have_p, specs.planes))
    scale = t.scale
    if scale is not None:
        have_s = t.sharding.scale if t.sharding else \
            (None,) * len(scale_shape)
        scale = _own(relayout(scale, mesh, have_s, specs.scale))
    return dataclasses.replace(t, planes=planes, scale=scale,
                               sharding=ResidueSharding(
                                   ctx, specs.planes, specs.scale,
                                   planes_shape, scale_shape))


def unshard_residue_tensor(t: Any) -> Any:
    """The whole ResidueTensor from this rank's block (gathers over the
    mesh); an unsharded tensor as it is."""
    sh = t.sharding
    if sh is None:
        return t
    mesh = sh.ctx.mesh
    planes = relayout(t.planes, mesh, sh.planes, (None,) * len(sh.planes))
    scale = t.scale
    if scale is not None:
        scale = relayout(scale, mesh, sh.scale, (None,) * len(sh.scale))
    return dataclasses.replace(t, planes=planes, scale=scale, sharding=None)


def shard_params(params: Any, ctx: ShardCtx, **kw: Any) -> Any:
    """Every ResidueTensor of a (prepared) tree as this rank's block on its
    :func:`param_specs` specs.  Float leaves stay whole (module
    docstring)."""
    tp_size = ctx.axis_size("tp")

    def place(path, leaf, in_list):
        if not _is_residue(leaf):
            return leaf
        return shard_residue_tensor(
            leaf, rule_roles(path, leaf.shape, tp_size, in_list=in_list,
                             **kw), ctx)

    return _tree_map(place, params)


# ---------------------------------------------------------------------------
# Float trees on their blocks (the train state) and the training forward's
# sharded parameters.
# ---------------------------------------------------------------------------


def spec_axes_of(spec: Sequence) -> set[str]:
    """Every axis name a spec splits a dim over."""
    return {a for e in spec for a in spec_axes(e)}


def place_tree(tree: Any, specs: Any, ctx: ShardCtx) -> Any:
    """This rank's block of every leaf of a float tree (dicts and lists of
    tensors) on its spec: compact copies, so the whole leaves can be
    freed."""
    def place(x, spec):
        _check_ranked(ctx, x)
        return _own(relayout(x, ctx.mesh, (None,) * x.dim(), spec))

    return tree_map(place, tree, specs)


def gather_tree(tree: Any, specs: Any, ctx: ShardCtx) -> Any:
    """The whole tree from this rank's blocks (collective: every rank of
    the mesh calls it)."""
    return tree_map(lambda x, spec: relayout(x, ctx.mesh, spec,
                                             (None,) * x.dim()), tree, specs)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedParam:
    """This rank's block of a float weight in the training forward and
    where it sits (``spec`` on ``ctx.mesh``).

    :meth:`gather_dp` brings the FSDP split together (backward:
    reduce-scatter, the gradient summed over the dp ranks' rows), once a
    forward: the object is made for one micro-batch's forward tree, and
    every use of the weight in it (the tied table's embedding and logits
    through :attr:`T`, a remat'd layer's recompute) shares the gathered
    tensor, so its gradients meet in one reduce-scatter; :meth:`tp_dim`
    names the dim the tensor axes split, which picks the plan
    (``models/linear.py``); :meth:`whole` gathers the tensor axes too
    (backward: the local block, the consumers being replicated over
    them)."""

    block: torch.Tensor
    spec: Spec
    ctx: ShardCtx
    _memo: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def T(self) -> "ShardedParam":
        """The transposed weight, sharing this one's dp gather."""
        if self.block.dim() != 2:
            raise ValueError("ShardedParam.T takes a 2-D weight")
        return ShardedParam(self.block.T, Spec(*reversed(self.spec)),
                            self.ctx, {"dp": self.gather_dp().T})

    def _gathered(self, axes: tuple[str, ...], grad: str) -> torch.Tensor:
        x = self.block
        for d, e in enumerate(self.spec):
            mine = tuple(a for a in spec_axes(e) if a in axes)
            if mine and mine != spec_axes(e):
                raise ValueError(f"spec {self.spec} mixes dp and tp axes on "
                                 f"dim {d}")
            if mine:
                x = collectives.diff_all_gather(x, d, self.ctx.mesh, mine,
                                                grad)
        return x

    def gather_dp(self) -> torch.Tensor:
        """The block with its dp split gathered (tp split kept)."""
        if "dp" not in self._memo:
            self._memo["dp"] = self._gathered(self.ctx.dp, "sum")
        return self._memo["dp"]

    def tp_dim(self) -> int | None:
        """The dim the tensor axes split (None: replicated over them)."""
        for d, e in enumerate(self.spec):
            if spec_axes(e) and set(spec_axes(e)) <= set(self.ctx.tp):
                if spec_axes(e) != tuple(self.ctx.tp):
                    raise ValueError(f"spec {self.spec}: a dim split over "
                                     f"part of the tensor axes")
                return d
        return None

    def whole(self) -> torch.Tensor:
        """The whole weight on every rank."""
        x = self.gather_dp()
        d = self.tp_dim()
        if d is None:
            return x
        return collectives.diff_all_gather(x, d, self.ctx.mesh, self.ctx.tp,
                                           "slice")


def dp_rows():
    """``(mesh, dp axes, dp size)`` when the installed context's rows are
    split over more than one dp rank (``rows_local``: the train step),
    else None: the global batch's reductions (the loss, the moe routing)
    then sum over them."""
    ctx = get_shard_ctx()
    if ctx is None or not ctx.rows_local or not ctx.dp:
        return None
    n = collectives.axis_size(ctx.mesh, ctx.dp)
    return (ctx.mesh, ctx.dp, n) if n > 1 else None
