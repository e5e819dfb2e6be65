"""Typed configuration tree — the PyTorch port's copy of
dpg_slam_tpu/config.py.

Same frozen dataclass tree, field names, defaults and JSON form as the
JAX package's config (the parity contract between the two packages):
``DpgConfig.from_json`` reads a JAX checkpoint's config.json unchanged.
It is a copy rather than an import because importing any module of
dpg_slam_tpu imports jax, which the port never does. The comments here
give each knob's meaning; the reasoning behind the defaults, with the
reference's parameters.h provenance, is in dpg_slam_tpu/config.py.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """Fixed-shape scan geometry: one scan is a (num_beams,) range vector."""

    num_beams: int = 1024
    angle_min: float = -2.35619449  # -3π/4, typical Hokuyo FOV
    angle_max: float = 2.35619449
    range_min: float = 0.02
    range_max: float = 10.0

    @property
    def angle_increment(self) -> float:
        # (angle_max - angle_min) / (n - 1), dpg_slam.cc:497.
        return (self.angle_max - self.angle_min) / (self.num_beams - 1.0)


@dataclasses.dataclass(frozen=True)
class PoseGraphParams:
    """Pose-graph frontend/backend tunables (parameters.h:105-407)."""

    # ICP
    icp_maximum_iterations: int = 60
    icp_maximum_transformation_epsilon: float = 5e-9  # freeze when step² <= this
    icp_max_correspondence_distance: float = 0.6      # fine gate (m)
    ransac_iterations: int = 50
    ransac_outlier_rejection_threshold: float = 0.05
    icp_use_ransac_rejection: bool = False  # off by default; on, ICP runs its plain version (ops/icp.py)
    icp_use_reciprocal_correspondences: bool = True
    downsample_icp_points_ratio: int = 5  # keep 1 in 5 beams
    icp_point_to_line: bool = True        # False: point-to-point, on the plain version (ops/icp.py)
    icp_max_points: int = 256             # padded per-cloud point budget
    use_pallas_icp: bool = False
    # Kept for JSON parity with the JAX package and ignored by the port:
    # the tensor's device picks the ICP path (ops/icp.icp_align — the plain
    # PyTorch version on CPU, the CUDA kernel on a GPU for point-to-line
    # without RANSAC).
    icp_coarse_gate_multiplier: float = 3.0
    # Loop-closure pairs start at this multiple of the fine gate and anneal
    # to 1x (successive pairs use 1x).
    reoptimize_gate_multiplier: float = 1.0  # the same for reoptimize closures
    icp_anneal_iters: int | None = 10
    # Annealing length in iterations (None: 2/3 of icp_maximum_iterations).
    icp_error_delta_rel_tol: float = 3e-3
    # A pair also freezes when its fitness improved by less than this
    # relative amount in one iteration (0.0 disables).
    icp_min_overlap: float = 0.5
    # Acceptance: fraction of valid source points with a correspondence.

    # Loop closure search
    maximum_node_dist_within_pass_scan_comparison: float = 5.0
    maximum_node_dist_across_passes_scan_comparison: float = 2.0
    max_loop_closures_per_node: int = 8   # K candidates per node
    min_loop_closure_node_gap: int = 10   # same-pass closures only this far back
    closure_consistency_transl: float = 0.2
    closure_consistency_rot: float = 0.15
    # Closures vote on the drift correction they imply; only the plurality
    # group is kept. None disables the vote.

    # Keyframe gating
    min_dist_between_nodes: float = 1.0
    min_angle_between_nodes: float = math.pi / 6.0

    # Per-pass origin prior sigmas
    new_pass_x_std_dev: float = 0.2
    new_pass_y_std_dev: float = 0.2
    new_pass_theta_std_dev: float = 0.15

    # Motion model
    motion_model_transl_error_from_transl: float = 0.4
    motion_model_transl_error_from_rot: float = 0.4
    motion_model_rot_error_from_transl: float = 0.4
    motion_model_rot_error_from_rot: float = 0.4

    # Laser extrinsics: pose of the laser in base_link
    laser_x_in_bl_frame: float = 0.2
    laser_y_in_bl_frame: float = 0.0
    laser_orientation_rel_bl_frame: float = 0.0

    # Constraint toggles
    non_successive_scan_constraints: bool = True
    odometry_constraints: bool = True

    # Observation (ICP) covariance
    laser_x_variance: float = 0.5
    laser_y_variance: float = 0.5
    laser_theta_variance: float = 0.3
    use_fixed_icp_covariance: bool = False
    # True: the constant diagonal above (reference parity); False: the
    # closed-form covariance of icp_covariance_mode.
    icp_sensor_noise_std: float = 0.02  # per-point noise for the live covariance
    icp_covariance_mode: str = "gn"
    # "gn": 2 sigma^2 H^-1 from the final normal system; "censi": the full
    # closed-form sandwich (ops/icp.censi_covariance).
    icp_cov_floor_transl: float = 0.0
    icp_cov_floor_rot: float = 0.0
    # Optional additive floor on the live covariance (sigma, m / rad).

    # Solver
    gtsam_max_iterations: int = 100  # caps gn_max_iterations of the full solve
    gn_max_iterations: int = 20      # full solves (reoptimize)
    incremental_gn_iterations: int = 5  # warm-started per-keyframe solves
    gn_damping_init: float = 1e-4
    incremental_cg_iterations: int = 64  # CG budget of the per-keyframe solves
    gn_tol: float = 1e-5             # LM relative-improvement stop (full solve)
    gn_gradient_tol: float = 1e-4    # skip/stop below this max-abs gradient
    robust_delta: float | None = 2.0  # Huber threshold (None: quadratic)


@dataclasses.dataclass(frozen=True)
class DpgParams:
    """Dynamic-pose-graph tunables (parameters.h:33-88), read by
    dpg.change_detection."""

    num_sectors: int = 5
    current_pose_chain_len: int = 5
    num_bins_for_change_detection: int = 72
    delta_change_threshold: float = 0.20
    min_changed_bins_for_commit: int = 2
    current_pose_graph_coverage_threshold: float = 1.0
    occ_grid_resolution: float = 0.05
    minimum_percent_active_sectors: float = 0.5
    distance_threshold_for_local_submap_nodes: float = 5.0
    grid_extent_cells: int = 1024
    max_submap_nodes: int = 32
    submap_coverage_growth: bool = False
    max_submap_candidates: int = 64
    coverage_coarse_factor: int = 8
    local_registration: bool = True
    local_reg_max_points: int = 2048
    change_margin_cells: int = 2
    min_free_views: int = 2
    replicate_int_bin_ratio: bool = False


@dataclasses.dataclass(frozen=True)
class VisualizationParams:
    """Map-export thinning (parameters.h:14-28)."""

    display_points_fraction: int = 10


@dataclasses.dataclass(frozen=True)
class CapacityParams:
    """Static capacities of the state tensors; exceeding one raises on the
    host."""

    max_nodes: int = 512
    max_edges: int = 8192  # >= max_nodes * (2 + max_loop_closures_per_node)
    max_priors: int = 16   # one per pass
    max_passes: int = 16   # increment_pass raises when exhausted


@dataclasses.dataclass(frozen=True)
class DpgConfig:
    """Root config."""

    scan: ScanParams = dataclasses.field(default_factory=ScanParams)
    pose_graph: PoseGraphParams = dataclasses.field(default_factory=PoseGraphParams)
    dpg: DpgParams = dataclasses.field(default_factory=DpgParams)
    viz: VisualizationParams = dataclasses.field(default_factory=VisualizationParams)
    capacity: CapacityParams = dataclasses.field(default_factory=CapacityParams)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DpgConfig":
        return cls(
            scan=ScanParams(**d.get("scan", {})),
            pose_graph=PoseGraphParams(**d.get("pose_graph", {})),
            dpg=DpgParams(**d.get("dpg", {})),
            viz=VisualizationParams(**d.get("viz", {})),
            capacity=CapacityParams(**d.get("capacity", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "DpgConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "DpgConfig":
        return dataclasses.replace(self, **kwargs)
