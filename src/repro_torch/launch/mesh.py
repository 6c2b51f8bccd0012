"""Process groups and device meshes (port of ``repro/launch/mesh.py``).

One process a rank.  :func:`init_process_group` joins the group from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT``) or from an explicit ``file://`` init
method, and names its backend: ``nccl`` when every rank of the host has a
card of its own, ``gloo`` on the CPU and for ranks that share a card (NCCL
refuses two ranks on one device).  The meshes are
``torch.distributed.device_mesh.DeviceMesh``\\ es over the ranks in row-major
order; the runners take their groups from them, never a backend of their
own.

:func:`abstract_production_mesh` gives the reference's production meshes
as :class:`~repro_torch.parallel.sharding.AbstractMesh`` objects (sizes, no
ranks): the dry run (``launch/dryrun.py``) costs rank 0's program on them
with no process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.parallel.sharding import AbstractMesh, ShardCtx

__all__ = ["choose_backend", "init_process_group", "make_production_mesh",
           "abstract_production_mesh", "make_ctx", "make_test_mesh"]


def choose_backend(local_world_size: int) -> str:
    """``"nccl"`` when each of the host's ``local_world_size`` ranks can
    have a card of its own, else ``"gloo"``."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_process_group(*, backend: str | None = None,
                       init_method: str | None = None,
                       rank: int | None = None,
                       world_size: int | None = None) -> str:
    """Join the process group and return its backend's name.

    With no arguments the rank, the world size and the rendezvous come from
    ``torchrun``'s environment; otherwise pass ``init_method`` (e.g.
    ``"file:///tmp/x/init"``), ``rank`` and ``world_size``.  ``backend``
    defaults to :func:`choose_backend` over the ranks of this host.
    """
    env = os.environ
    if rank is None:
        rank = int(env["RANK"])
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = choose_backend(int(env.get("LOCAL_WORLD_SIZE",
                                             world_size)))
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          ranks=None) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    if ranks is None:
        if dist.get_world_size() < n:
            raise RuntimeError(f"mesh {shape} needs {n} ranks, the group "
                               f"has {dist.get_world_size()}")
        ranks = range(n)
    grid = torch.as_tensor(list(ranks), dtype=torch.int64).reshape(shape)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, grid, mesh_dim_names=tuple(axes))


def make_production_mesh(*, channel: int | None = None) -> DeviceMesh:
    """The whole group as one mesh: ``(world // channel, channel)`` over
    ``("data", "model")`` for channel-parallel runs (the model axis sized
    to the moduli set's C), else ``(1, world)``: tensor parallelism over
    the host's cards."""
    world = dist.get_world_size()
    if channel is not None:
        if channel < 2 or world % channel:
            raise ValueError(f"channel axis {channel} must be >= 2 and "
                             f"divide the world size {world}")
        shape = (world // channel, channel)
    else:
        shape = (1, world)
    return _mesh(shape, ("data", "model"))


def abstract_production_mesh(*, multi_pod: bool = False,
                             channel: int | None = None) -> AbstractMesh:
    """The reference's pod meshes (``repro/launch/mesh.py``), sizes only:
    single (16, 16) over ("data", "model"), multi (2, 16, 16) over ("pod",
    "data", "model"), and with ``channel=C`` the channel-parallel (256 //
    C, C) over ("data", "model"), the model axis sized to the moduli
    channel count (single-pod only)."""
    if channel is not None:
        if multi_pod:
            raise ValueError("channel-parallel meshes are single-pod")
        if channel < 2 or channel > 256:
            raise ValueError(f"channel axis must be in [2, 256], got "
                             f"{channel}")
        return AbstractMesh((256 // channel, channel), ("data", "model"))
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_ctx(mesh, *, seq_shard: bool = False,
             channel_shard: bool = False) -> ShardCtx:
    """ShardCtx with dp = every axis but ``"model"``; ``seq_shard`` puts the
    training forward's norms and residual adds on sequence shards over the
    model axis (Megatron-SP), ``channel_shard`` selects the channel-split
    plane layout (parallel/sharding.py)."""
    names = (mesh.axis_names if hasattr(mesh, "axis_names")
             else mesh.mesh_dim_names)
    dp = tuple(a for a in names if a != "model")
    return ShardCtx(mesh, dp=dp, tp=("model",), seq_shard=seq_shard,
                    channel_shard=channel_shard)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   ranks=None) -> DeviceMesh:
    """A small mesh over the group's first ranks, or over ``ranks`` (every
    rank of the group builds it; a rank outside it is no member)."""
    return _mesh(tuple(shape), tuple(axes), ranks)
