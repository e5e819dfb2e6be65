"""Multi-process runtime bootstrap — the port of
dpg_slam_tpu/parallel/multihost.py.

Processes join one ``torch.distributed`` process group, and the mesh over
every rank (``global_mesh``) splits the distributed solvers' shards over
them (parallel/mesh.py). On cards the backend is NCCL, one card a rank;
gloo runs only when the caller names the CPU. One never replaces the
other.

A run with none of torch's launcher variables set (a single process)
skips the initialization, so the same script runs alone or under
``torchrun --nproc-per-node=W``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dpg_slam_tpu_torch.parallel.mesh import Mesh

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
) -> bool:
    """Join (or skip) a multi-process torch.distributed job.

    The arguments default from torchrun's variables: MASTER_ADDR and
    MASTER_PORT ("host:port" as coordinator_address), WORLD_SIZE and RANK;
    a rank's card is LOCAL_RANK (else the rank modulo the cards here).
    device "cuda" joins over NCCL and raises where there is no card;
    "cpu" joins over gloo. Returns True if a process group was joined,
    False where nothing says there is one (as the JAX package's does).
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process job needs a coordinator address, a process count and a process id "
                         f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost(device='cuda') needs a card; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(n_shards: int | None = None) -> Mesh:
    """The mesh over every rank of the joined job: n_shards shards
    (default one a rank; a multiple of the world size), S / W of them on
    this rank's device (its card under NCCL, the CPU under gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh() needs initialize_multihost() to have joined a job")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    n = world if n_shards is None else int(n_shards)
    if n < world or n % world:
        raise ValueError(f"{n} shards do not split over {world} ranks")
    return Mesh(n, device, dist.group.WORLD, rank, world)
