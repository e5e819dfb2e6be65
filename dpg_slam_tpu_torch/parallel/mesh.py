"""Shard layout of the distributed solvers — the port of
dpg_slam_tpu/parallel/mesh.py.

The JAX package runs its distributed solvers under ``shard_map`` on a 1-D
device mesh, with ``psum`` over the mesh axis as the only communication.
Here a mesh is a shard count and one device: the mesh axis becomes a
leading shard dimension of the tensors, every per-shard step runs batched
over it, and ``psum`` becomes a sum over that dimension (as the JAX tests
do on their virtual 8-device CPU mesh). The numbers are those of S devices
doing the same work; the wall clock is one card's.

Splitting the shard dimension over processes and cards with
``torch.distributed`` is not done yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh(NamedTuple):
    """S shards on one device."""

    size: int
    device: torch.device


def make_mesh(n_shards: int, device="cuda") -> Mesh:
    """A mesh of `n_shards` shards on `device` (the card unless the caller
    names another)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh(int(n_shards), torch.device(device))
