"""The sharded fleet engine's shard group: the counterpart of
``repro.launch.mesh.make_fleet_mesh``.

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

from typing import NamedTuple

import torch


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
