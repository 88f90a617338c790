"""Batches laid over the ranks of a ``torch.distributed`` ``DeviceMesh``.

The samplers run in SPMD style: every rank calls the entry point with the
same arguments, holds a contiguous block of the batch's rows (chains,
particles or ELBO draws), and draws the whole batch's random numbers from
the same generator seed, keeping its own rows (`hmc.own_rows`). What the
reference's sharded ``jax.Array`` gives every process, the whole result, comes
from one ``all_gather`` per output here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class Shard(NamedTuple):
    group: object  # the process group of the mesh dimension
    world: int
    rank: int
    total: int  # rows of the whole batch
    start: int  # this rank's first row
    stop: int

    @property
    def rows(self) -> tuple:
        """The (total, start) of `hmc.own_rows`."""
        return self.total, self.start


def shard(mesh, axis: str | None, total: int, error: str) -> Shard:
    """This rank's rows of a batch of `total` laid over `mesh`'s dimension
    `axis` (by name; None: dimension 0). Raises ValueError(`error` formatted
    with total, axis and world) when `total` does not divide over that
    dimension's ranks, as the reference does."""
    group = mesh.get_group(axis if axis is not None else 0)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if total % world != 0:
        axis = axis if axis is not None else (mesh.mesh_dim_names or ("0",))[0]
        raise ValueError(error.format(total=total, axis=axis, world=world))
    per = total // world
    return Shard(group, world, rank, total, rank * per, (rank + 1) * per)


def gather(sh: Shard, t: torch.Tensor) -> torch.Tensor:
    """Every rank's block of t along dim 0, in rank order, on every rank."""
    as_bool = t.dtype == torch.bool
    t = (t.to(torch.uint8) if as_bool else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(sh.world)]
    dist.all_gather(parts, t, group=sh.group)
    out = torch.cat(parts)
    return out.bool() if as_bool else out


def all_sum(sh: Shard, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of t, on every rank."""
    t = t.clone()
    dist.all_reduce(t, group=sh.group)
    return t
