"""Distributed execution over a mesh of shards: sharded ICP, the
edge-sharded CG solve, the Schur-elimination solve and the distributed
reoptimize (the port of dpg_slam_tpu/parallel/), in one process
(make_mesh) or over the ranks of a torch.distributed process group
(multihost.initialize_multihost, then multihost.global_mesh); see mesh.py
for what a mesh is here."""

from dpg_slam_tpu_torch.parallel.mesh import make_mesh
from dpg_slam_tpu_torch.parallel.multihost import global_mesh, initialize_multihost
from dpg_slam_tpu_torch.parallel.distributed import (
    sharded_icp_align,
    distributed_solve,
    distributed_reoptimize,
)
from dpg_slam_tpu_torch.parallel.schur import schur_solve

__all__ = [
    "make_mesh",
    "initialize_multihost",
    "global_mesh",
    "sharded_icp_align",
    "distributed_solve",
    "distributed_reoptimize",
    "schur_solve",
]
