"""Shard layout of the distributed solvers — the port of
dpg_slam_tpu/parallel/mesh.py.

The JAX package runs its distributed solvers under ``shard_map`` on a 1-D
device mesh, with ``psum`` over the mesh axis as the only communication.
Here a mesh is S shards over the ranks of a ``torch.distributed`` process
group, S / W shards a rank (rank r holds shards [r·S/W, (r+1)·S/W)), or
over one process when there is no group (``make_mesh``). The mesh axis is
a leading shard dimension of the tensors: each rank runs the per-shard
steps of its own shards batched over it, and each ``psum`` is an
``all_gather`` of every rank's per-shard values in shard order followed by
the sum over the shard dimension (``gather_shards``). The sum is the one
the one-process mesh takes, so W ranks give the one-process S-shard
result to the bit wherever every rank holds at least two shards (a
batched matmul over one matrix rounds as a plain matrix product, not as
the batch). ``all_reduce`` would add in another order.

``make_mesh(S)`` on one process is the W = 1 case with no group: the same
ops and bits as before the process group existed. ``parallel/multihost.py``
joins the process group and builds the mesh over every rank.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "gather_shards"]


class Mesh(NamedTuple):
    """S shards over the W ranks of a process group (group None: one
    process holds them all)."""

    size: int
    device: torch.device
    group: Any = None
    rank: int = 0
    world: int = 1

    @property
    def shards(self) -> tuple[int, int]:
        """[first, last) shard of this rank."""
        per = self.size // self.world
        return self.rank * per, (self.rank + 1) * per


def make_mesh(n_shards: int, device="cuda") -> Mesh:
    """A mesh of `n_shards` shards in this process on `device` (the card
    unless the caller names another)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh(int(n_shards), torch.device(device))


def gather_shards(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's per-shard values x (S / W, ...) -> every shard's
    (S, ...), in shard order, on every rank: one all_gather (x itself on a
    mesh without a group)."""
    if mesh.group is None:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
