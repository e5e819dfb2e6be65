"""dpg_slam_tpu_torch — the PyTorch/CUDA port of dpg_slam_tpu.

The JAX package (dpg_slam_tpu/) is the reference; this package mirrors its
module layout so each module's counterpart is found by path:

  config     — the same frozen dataclass tree (JSON-compatible)
  geom       — SE(2) math on tensors
  scan       — scan data model
  ops.icp    — batched ICP (plain PyTorch: point-to-line or
               point-to-point, optional RANSAC rejection) + covariance;
               point-to-line without RANSAC on a CUDA tensor launches the
               hand-written kernel in ops.icp_cuda (csrc/icp_kernel.cu)
  ops.schur  — batched SPD solve (plain PyTorch); on a CUDA tensor it
               launches the hand-written kernel in ops.schur_cuda
               (csrc/spd_solve_kernel.cu)
  ops.raster — occupancy rasterization into dense int8 windows
  graph      — factor-graph LM solver (one graph, or S on a lane axis)
  parallel   — sharded ICP, edge-sharded CG, Schur-elimination solve and
               distributed reoptimize over S shards, in one process or
               over the ranks of a torch.distributed group (multihost)
  dpg        — DPG change detection (execute_dpg, and execute_dpg_lanes
               over a lane axis), map layers and the occupancy snapshot
  engine     — SLAM session engine: online keyframe path with a DPG step
               on every keyframe of pass >= 1, offline process_sequence
               and the pass-boundary reoptimize
  batch      — session-batched mode: S sessions' keyframes a step, their
               ICP pairs in one call (process_sessions_batched); the
               multipass mode over S lanes, with every lane's DPG step and
               pass-boundary reoptimize batched
               (process_sessions_multipass, batched_increment_pass); the
               online server of S live streams (BatchedSlamServer)
  utils      — checkpoints (save and load, in the JAX package's npz
               format), metrics, profiling (torch.profiler, stage timer)
  io         — synthetic worlds and sequences, .npz / .dsl logs, the gdc /
               mit suites and manifests, ROS1 bags, stream conversion
  viz        — map export and PNG rendering (matplotlib, imported on use)
  baselines  — the serial CPU / native C++ reference-equivalent baseline
  run        — the experiment runner (python -m dpg_slam_tpu_torch.run)

Rules: the package imports torch and numpy, never jax or dpg_slam_tpu.
Entry points (DpgSlamEngine, process_sessions_batched, BatchedSlamServer,
process_sessions_multipass, load_checkpoint, make_mesh, run) run on the card
unless the caller names another device; below
them every function works on the device of the tensors it is given.
"""

import torch as _torch

# Geometry needs real f32 products: the JAX package forces
# jax_default_matmul_precision="highest" because bf16 rounding of ICP
# distances and normal equations gave 5.5 m office ATE against 0.10 m.
# TF32 keeps ~10 mantissa bits, so both TF32 switches go off here.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from dpg_slam_tpu_torch.config import (  # noqa: E402
    DpgConfig,
    DpgParams,
    PoseGraphParams,
    ScanParams,
    VisualizationParams,
)
from dpg_slam_tpu_torch import geom, scan  # noqa: E402
from dpg_slam_tpu_torch.batch import (  # noqa: E402
    BatchedSlamServer,
    batched_increment_pass,
    process_sessions_batched,
    process_sessions_multipass,
    session_state,
)

__version__ = "0.1.0"

__all__ = [
    "DpgConfig",
    "DpgParams",
    "PoseGraphParams",
    "ScanParams",
    "VisualizationParams",
    "geom",
    "scan",
    "BatchedSlamServer",
    "batched_increment_pass",
    "process_sessions_batched",
    "process_sessions_multipass",
    "session_state",
]
