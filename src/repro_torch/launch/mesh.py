"""Device meshes: the architecture models' ``make_host_mesh`` /
``make_production_mesh`` (the counterparts of ``repro.launch.mesh``'s), and
the sharded fleet engine's shard group (``make_fleet_mesh``'s).

A ``Mesh`` lays the ranks of ``torch.distributed``'s default group over
named axes ("data", "model") or ("pod", "data", "model"), row-major as
``jax.make_mesh`` lays devices: rank = (pod * |data| + data) * |model| +
model.  It is built over ``torch.distributed.device_mesh.init_device_mesh``
(gloo on the CPU, NCCL on the cards, one card a rank: ``cuda:LOCAL_RANK``,
as ``ShardGroup.device`` places it) and gives each axis, and the fl axes
("pod", "data") together, as a ``models.sharding.AxisGroup``.  A world
whose size is not the mesh's product raises.  Without
``torch.distributed`` only a mesh of one rank exists, and its collectives
are no-ops.

The reference lays its S shards over a 1-D ``fl`` device mesh and runs the
step inside ``shard_map``, one shard a device.  Here a process holds L
shards, their rows stacked on the leading axis, and ``ShardGroup`` carries
what crosses shards: an all-gather of per-shard payloads (the halo's
boundary rows, the per-device channels in global order) and the sums and
maxima over shards that ``psum`` and ``pmax`` take in the reference.

* One process (``torch.distributed`` not initialized): L = S and every
  collective is a no-op on the stacked shards.
* Under ``torch.distributed`` (NCCL across cards, gloo across CPU
  processes): each of the ``world`` ranks holds L = S / world consecutive
  shards, and every collective goes through the default process group,
  at world size 1 too.  On the card each rank runs on its own GPU
  (``ShardGroup.device``: ``cuda:LOCAL_RANK``).

Sums and maxima gather every shard's partial and reduce them in shard
order on every rank, so a run gives the same bits at every world size.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.sharding import AxisGroup


class Mesh:
    """Named mesh axes over the ranks, and this rank's place on them."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 rank: int = 0, device_mesh: Any = None, groups: dict | None = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = int(np.prod(shape))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self.device_mesh = device_mesh
        self._groups = groups or {}

    def axis(self, axes) -> AxisGroup:
        """The axis (or tuple of axes, flattened row-major) as this rank's
        ``AxisGroup``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        size = int(np.prod([self.shape[a] for a in names])) if names else 1
        index = 0
        for a in names:
            index = index * self.shape[a] + self.coords[a]
        return AxisGroup(size, index, self._groups.get(names) if size > 1 else None)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, coords {self.coords})"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    import torch.distributed as dist

    size = int(np.prod(shape))
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise ValueError(
                f"a mesh of shape {dict(zip(axes, shape))} needs {size} ranks, but "
                f"torch.distributed is not initialized (a world of 1): launch {size} "
                f"ranks (torchrun --nproc-per-node {size}) and init the process group")
        return Mesh(shape, axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != size:
        raise ValueError(
            f"a mesh of shape {dict(zip(axes, shape))} needs {size} ranks, but the "
            f"process group has {world}: launch a world of their product")
    from torch.distributed.device_mesh import init_device_mesh

    on_card = dist.get_backend() == "nccl"
    if on_card:
        ShardGroup(1, world, rank, True).device(torch.device("cuda"))
    dm = init_device_mesh("cuda" if on_card else "cpu", tuple(shape), mesh_dim_names=axes)
    groups = {(a,): dm.get_group(a) for a in axes}
    groups[tuple(axes)] = dist.group.WORLD  # every rank, in rank order
    ids = np.arange(size).reshape(shape)
    # the fl axes ("pod", "data") as one group: every rank makes every
    # such group, in the same order
    for pair in (("pod", "data"),):
        if all(a in axes for a in pair):
            keep = [axes.index(a) for a in pair]
            rest = [i for i in range(len(axes)) if i not in keep]
            flat = np.moveaxis(ids, keep + rest, list(range(len(axes)))).reshape(
                int(np.prod([shape[i] for i in keep])), -1)
            for col in range(flat.shape[1]):
                ranks = [int(r) for r in flat[:, col]]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[pair] = g
    return Mesh(shape, axes, rank, dm, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(*, data: int = 2, model: int = 2, pods: int = 0) -> Mesh:
    """A (data, model) mesh, or (pods, data, model) with ``pods``, over the
    ranks of the default process group."""
    if pods:
        return _mesh((pods, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


class ShardGroup(NamedTuple):
    n_shards: int  # S, the fleet's shards
    world: int  # ranks (1 without a process group)
    rank: int
    distributed: bool  # whether collectives go through torch.distributed

    @property
    def local(self) -> int:
        """L, the shards this rank holds."""
        return self.n_shards // self.world

    @property
    def shards(self) -> range:
        """The global ids of this rank's shards."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) per-shard payloads -> (S, ...) of every shard, in shard
        order."""
        if not self.distributed:
            return x
        import torch.distributed as dist

        # bool payloads travel as bytes: every backend takes uint8
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        out = torch.cat(parts)
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) per-shard partial sums -> their sum over every shard,
        added in shard order (``psum``)."""
        return self.all_gather(x).sum(dim=0)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) per-shard maxima -> the max over every shard
        (``pmax``)."""
        return self.all_gather(x).amax(dim=0)

    def device(self, dev: torch.device) -> torch.device:
        """The run's device on this rank.  Under ``torch.distributed`` a
        CUDA device without an index is the rank's own card,
        ``cuda:LOCAL_RANK`` (the rank modulo the visible cards where no
        launcher set ``LOCAL_RANK``); the rank's card is made the current
        device, so that NCCL's communicators bind to it."""
        if not self.distributed or dev.type != "cuda":
            return dev
        if dev.index is None:
            import os

            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else self.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev

    def key(self) -> tuple:
        """What an engine built for this group depends on (the engine
        cache's key)."""
        if not self.distributed:
            return ("one process",)
        import torch.distributed as dist

        return (self.world, self.rank, id(dist.group.WORLD))


def make_fleet_group(n_shards: int) -> ShardGroup:
    """The shard group of an ``n_shards`` sharded run: the default process
    group when ``torch.distributed`` is initialized (each rank then holds
    ``n_shards / world`` shards), this one process otherwise."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1; got {n_shards}")
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return ShardGroup(n_shards, 1, 0, False)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_shards % world:
        raise ValueError(
            f"fleet group needs n_shards divisible by the {world} ranks of the "
            f"process group (each rank holds n_shards / world shards); got "
            f"n_shards={n_shards}: launch a world size that divides it, or run "
            f"in one process without torch.distributed")
    return ShardGroup(n_shards, world, rank, True)
