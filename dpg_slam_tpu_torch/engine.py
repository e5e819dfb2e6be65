"""SLAM session engine — the port of dpg_slam_tpu/engine.py: the online
keyframe path, the offline sequence mode (process_sequence), the
pass-boundary reoptimize and, on every keyframe of pass >= 1, DPG change
detection (dpg.execute_dpg).

The state is a NamedTuple of fixed-capacity tensors with the JAX
package's field names and shapes, so a JAX checkpoint loads unchanged
(utils/checkpoint.py). Host decisions the JAX package takes under jit
with ``jnp.where`` on scalars (pass-first node, has-predecessor) are
Python branches here on values read from the device.
"""

from __future__ import annotations

import logging
import warnings
from typing import NamedTuple

import numpy as np
import torch

from dpg_slam_tpu_torch import geom, scan
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.dpg import change_detection
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.ops import icp
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["SlamState", "DpgSlamEngine"]

logger = logging.getLogger(__name__)


class SlamState(NamedTuple):
    """All engine state as fixed-capacity tensors (JAX field layout)."""

    poses: torch.Tensor          # (N, 3) current pose estimates
    odom_poses: torch.Tensor     # (N, 3) raw odometry pose at node creation
    pass_ids: torch.Tensor       # (N,) int32
    node_active: torch.Tensor    # (N,) bool
    ranges: torch.Tensor         # (N, B) float32 raw scans
    labels: torch.Tensor         # (N, B) int8 point labels
    sector_active: torch.Tensor  # (N, S) bool
    cloud: torch.Tensor          # (N, P, 2) downsampled base_link clouds
    cloud_mask: torch.Tensor     # (N, P) bool
    cloud_normals: torch.Tensor  # (N, P, 2)
    num_nodes: torch.Tensor      # () int32
    graph: fg.FactorGraph
    prev_odom: torch.Tensor            # (3,)
    odom_at_last_node: torch.Tensor    # (3,)
    cumulative_dist: torch.Tensor      # ()
    odom_initialized: torch.Tensor     # () bool
    first_scan_for_pass: torch.Tensor  # () bool
    pass_number: torch.Tensor          # () int32

    @property
    def node_mask(self) -> torch.Tensor:
        return torch.arange(self.poses.shape[0], device=self.poses.device) < self.num_nodes


# Per-node fields, sliced together to a node bucket by the reoptimize.
_NODE_FIELDS = (
    "poses", "odom_poses", "pass_ids", "node_active", "ranges", "labels",
    "sector_active", "cloud", "cloud_mask", "cloud_normals",
)


def _init_state(cfg: DpgConfig, device) -> SlamState:
    N = cfg.capacity.max_nodes
    B = cfg.scan.num_beams
    S = cfg.dpg.num_sectors
    P = cfg.pose_graph.icp_max_points
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SlamState(
        poses=z((N, 3)),
        odom_poses=z((N, 3)),
        pass_ids=z((N,), i32),
        node_active=z((N,), b8),
        ranges=z((N, B)),
        labels=torch.full((N, B), scan.MAX_RANGE, dtype=torch.int8, device=device),
        sector_active=z((N, S), b8),
        cloud=z((N, P, 2)),
        cloud_mask=z((N, P), b8),
        cloud_normals=z((N, P, 2)),
        num_nodes=z((), i32),
        graph=fg.empty_graph(cfg.capacity.max_priors, cfg.capacity.max_edges, device),
        prev_odom=z((3,)),
        odom_at_last_node=z((3,)),
        cumulative_dist=z(()),
        odom_initialized=z((), b8),
        first_scan_for_pass=torch.ones((), dtype=b8, device=device),
        pass_number=z((), i32),
    )


def _laser_pose_in_bl(cfg: DpgConfig, device) -> torch.Tensor:
    pg = cfg.pose_graph
    return geom.constant(
        [pg.laser_x_in_bl_frame, pg.laser_y_in_bl_frame, pg.laser_orientation_rel_bl_frame], device
    )


def _prior_sigmas(cfg: DpgConfig, device) -> torch.Tensor:
    """Sigmas of a pass-first node's prior (dpg_slam.cc:178-183)."""
    pg = cfg.pose_graph
    return geom.constant([pg.new_pass_x_std_dev, pg.new_pass_y_std_dev, pg.new_pass_theta_std_dev], device)


def _prepare_cloud(cfg: DpgConfig, ranges: torch.Tensor):
    """Scan -> labels, downsampled base_link cloud, mask and normals."""
    labels = scan.initial_labels(ranges, cfg.scan)
    pts_bl = scan.points_in_base_link(ranges, cfg.scan, _laser_pose_in_bl(cfg, ranges.device))
    pts, mask = scan.downsample(
        pts_bl, scan.valid_mask(labels),
        cfg.pose_graph.downsample_icp_points_ratio, cfg.pose_graph.icp_max_points,
    )
    return labels, pts, mask, icp.estimate_normals(pts, mask)


def _with_row(t: torch.Tensor, i: int, value) -> torch.Tensor:
    out = t.clone()
    out[i] = value
    return out


def _write_node(cfg: DpgConfig, state: SlamState, ranges, est_pose) -> SlamState:
    """Write a new node at slot num_nodes (createNode, dpg_slam.cc:488-513)."""
    i = int(state.num_nodes)
    labels, pts, mask, normals = _prepare_cloud(cfg, ranges)
    return state._replace(
        poses=_with_row(state.poses, i, est_pose),
        odom_poses=_with_row(state.odom_poses, i, state.prev_odom),
        pass_ids=_with_row(state.pass_ids, i, state.pass_number),
        node_active=_with_row(state.node_active, i, True),
        ranges=_with_row(state.ranges, i, ranges),
        labels=_with_row(state.labels, i, labels),
        sector_active=_with_row(state.sector_active, i, True),
        cloud=_with_row(state.cloud, i, pts),
        cloud_mask=_with_row(state.cloud_mask, i, mask),
        cloud_normals=_with_row(state.cloud_normals, i, normals),
        num_nodes=state.num_nodes + 1,
        odom_at_last_node=state.prev_odom,
        cumulative_dist=torch.zeros_like(state.cumulative_dist),
    )


def _motion_model_sigmas(cfg: DpgConfig, displ: torch.Tensor) -> torch.Tensor:
    """Odometry noise sigmas (..., 3) from the motion model
    (dpg_slam.cc:227-231), for (..., 3) displacements."""
    pg = cfg.pose_graph
    d = torch.linalg.norm(displ[..., 0:2], dim=-1)
    a = displ[..., 2].abs()
    transl = pg.motion_model_transl_error_from_transl * d + pg.motion_model_transl_error_from_rot * a
    rot = pg.motion_model_rot_error_from_transl * d + pg.motion_model_rot_error_from_rot * a
    return torch.clamp(torch.stack([transl, transl, rot], dim=-1), min=1e-3)


def _top_k_ascending(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest scores along the last axis, ties broken
    by the lower index (lax.top_k's order on -score; torch.topk promises
    no tie order, and invalid candidates all tie at inf)."""
    return torch.argsort(score, dim=-1, stable=True)[..., :k]


class _IcpBatchInputs(NamedTuple):
    """One node's (1+K)-pair ICP batch."""

    src: torch.Tensor          # (1+K, P, 2)
    src_mask: torch.Tensor     # (1+K, P)
    tgt: torch.Tensor          # (1+K, P, 2)
    tgt_mask: torch.Tensor     # (1+K, P)
    tgt_normals: torch.Tensor  # (1+K, P, 2)
    seeds: torch.Tensor        # (1+K, 3)
    gate: torch.Tensor         # (1+K,)


def _icp_pairs_for_new_node(cfg: DpgConfig, state: SlamState, new_idx: int, new_pose: torch.Tensor):
    """Successive pair + top-K loop-closure candidates for the new node
    (already written to the node arrays). Returns (inputs, tgt_idx,
    tgt_valid)."""
    pg = cfg.pose_graph
    K = pg.max_loop_closures_per_node
    N = state.poses.shape[0]
    dev = state.poses.device
    prec_idx = new_idx - 1

    dist = torch.linalg.norm(state.poses[:, 0:2] - new_pose[0:2], dim=-1)
    same_pass = state.pass_ids == state.pass_number
    thr = torch.where(
        same_pass,
        pg.maximum_node_dist_within_pass_scan_comparison,
        pg.maximum_node_dist_across_passes_scan_comparison,
    )
    idx = torch.arange(N, device=dev)
    gap_ok = ~same_pass | (new_idx - idx >= pg.min_loop_closure_node_gap)
    cand_ok = (idx < prec_idx) & (dist <= thr) & gap_ok
    cand_idx = _top_k_ascending(torch.where(cand_ok, dist, float("inf")), K)
    cand_valid = cand_ok[cand_idx]

    tgt_idx = torch.cat([torch.tensor([prec_idx], device=dev), cand_idx])
    tgt_valid = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), cand_valid])
    seeds = geom.between(state.poses[tgt_idx], new_pose.expand(1 + K, 3))
    # Successive pair: fine gate; closures: coarse-to-fine annealing.
    gate = torch.full((1 + K,), pg.icp_coarse_gate_multiplier, dtype=torch.float32, device=dev)
    gate[0] = 1.0
    inputs = _IcpBatchInputs(
        src=state.cloud[new_idx].expand(1 + K, -1, -1),
        src_mask=state.cloud_mask[new_idx].expand(1 + K, -1),
        tgt=state.cloud[tgt_idx],
        tgt_mask=state.cloud_mask[tgt_idx] & tgt_valid[:, None],
        tgt_normals=state.cloud_normals[tgt_idx],
        seeds=seeds,
        gate=gate,
    )
    return inputs, tgt_idx, tgt_valid


def _closure_consistency_votes(cfg, poses_tgt, transforms, ref_pose, valid):
    """Plurality vote over the drift corrections implied by closures,
    batched over leading axes: poses_tgt/transforms (..., K, 3), ref_pose
    (..., 3), valid (..., K). Returns the keep-mask (..., K)."""
    pg = cfg.pose_graph
    corr = geom.compose(poses_tgt, transforms) - ref_pose[..., None, :]
    corr = torch.cat([corr[..., :2], geom.wrap_angle(corr[..., 2:3])], dim=-1)
    d_t = torch.linalg.norm(corr[..., :, None, 0:2] - corr[..., None, :, 0:2], dim=-1)
    d_r = geom.wrap_angle(corr[..., :, None, 2] - corr[..., None, :, 2]).abs()
    agree = (
        (d_t <= pg.closure_consistency_transl)
        & (d_r <= pg.closure_consistency_rot)
        & valid[..., :, None]
        & valid[..., None, :]
    )
    votes = agree.sum(dim=-1)
    max_votes = torch.where(valid, votes, 0).amax(dim=-1, keepdim=True)
    return valid & (votes >= max_votes)


def _add_observation_factors(cfg, graph, res: icp.ICPResult, tgt_idx, tgt_valid, new_idx: int):
    """Between-factors from an ICP batch: slot 0 (successive) regardless of
    convergence (dpg_slam.cc:264-267), closures only when converged."""
    n_pairs = tgt_idx.shape[0]
    keep = tgt_valid & res.converged
    keep[0] = tgt_valid[0]
    return fg.add_between_batch(
        graph,
        tgt_idx,
        torch.full((n_pairs,), new_idx, dtype=tgt_idx.dtype, device=tgt_idx.device),
        res.transform,
        fg.sqrt_info_from_covariance(res.covariance),
        keep,
    )


def _keyframe_frontend_pre(cfg: DpgConfig, state: SlamState, ranges: torch.Tensor):
    """Pose estimate, prior/odometry factors, node write and ICP pair
    assembly. Returns (state, icp_inputs, tgt_idx, tgt_valid, est_pose,
    new_idx)."""
    pg = cfg.pose_graph
    dev = state.poses.device
    is_first = bool(state.first_scan_for_pass)
    new_idx = int(state.num_nodes)

    odom_displ = geom.between(state.odom_at_last_node, state.prev_odom)
    if is_first:
        est_pose = torch.zeros(3, device=dev)  # every pass starts at the origin
    else:
        prev_pose = state.poses[new_idx - 1] if new_idx > 0 else torch.zeros(3, device=dev)
        est_pose = geom.compose(prev_pose, odom_displ)

    graph = state.graph
    if is_first:
        graph = fg.add_prior(
            graph, new_idx, torch.zeros(3, device=dev), fg.sqrt_info_from_sigmas(_prior_sigmas(cfg, dev))
        )
    graph = fg.add_between(
        graph, new_idx - 1, new_idx, odom_displ,
        fg.sqrt_info_from_sigmas(_motion_model_sigmas(cfg, odom_displ)),
        valid=not is_first and pg.odometry_constraints,
    )
    state = _write_node(cfg, state, ranges, est_pose)._replace(graph=graph)
    icp_in, tgt_idx, tgt_valid = _icp_pairs_for_new_node(cfg, state, new_idx, est_pose)
    return state, icp_in, tgt_idx, tgt_valid, est_pose, new_idx


def _keyframe_frontend_post(cfg, state, res, tgt_idx, tgt_valid, est_pose, new_idx: int) -> SlamState:
    """Closure gating, consistency vote and factor insertion."""
    pg = cfg.pose_graph
    tgt_valid = tgt_valid & (new_idx > 0)
    if not pg.non_successive_scan_constraints:
        tgt_valid = tgt_valid & (torch.arange(tgt_valid.shape[0], device=tgt_valid.device) == 0)
    if pg.closure_consistency_transl is not None:
        voted = _closure_consistency_votes(
            cfg, state.poses[tgt_idx[1:]], res.transform[1:], est_pose,
            tgt_valid[1:] & res.converged[1:],
        )
        tgt_valid = torch.cat([tgt_valid[:1], voted])
    graph = _add_observation_factors(cfg, state.graph, res, tgt_idx, tgt_valid, new_idx)
    return state._replace(graph=graph, first_scan_for_pass=torch.zeros_like(state.first_scan_for_pass))


def _keyframe_frontend(cfg: DpgConfig, state: SlamState, ranges: torch.Tensor) -> SlamState:
    """A keyframe without its solve: node, (1+K)-pair ICP batch, factors."""
    state, icp_in, tgt_idx, tgt_valid, est_pose, new_idx = _keyframe_frontend_pre(cfg, state, ranges)
    res = icp.icp_align(
        icp_in.src, icp_in.src_mask, icp_in.tgt, icp_in.tgt_mask, icp_in.seeds,
        cfg.pose_graph, tgt_normals=icp_in.tgt_normals, gate_multiplier=icp_in.gate,
    )
    return _keyframe_frontend_post(cfg, state, res, tgt_idx, tgt_valid, est_pose, new_idx)


def _keyframe_solve(cfg: DpgConfig, state: SlamState, solve_method: str, solve_bucket: int | None = None) -> SlamState:
    """Warm-started LM over the live graph at the node bucket (factor
    tensors stay at full capacity, as in the JAX package)."""
    pg = cfg.pose_graph
    nb = solve_bucket or state.poses.shape[0]
    poses_b, _ = fg.solve(
        state.poses[:nb],
        state.graph,
        state.node_mask[:nb],
        max_iterations=pg.incremental_gn_iterations,
        damping_init=pg.gn_damping_init,
        method=solve_method,
        cg_iterations=pg.incremental_cg_iterations,
        robust_delta=pg.robust_delta,
        gradient_tol=pg.gn_gradient_tol,
        terminate_on_reject=True,
        rel_tol=1e-4,
    )
    return state._replace(poses=torch.cat([poses_b, state.poses[nb:]]))


def _keyframe_step(cfg, state, ranges, solve_method: str, solve_bucket: int | None = None) -> SlamState:
    """One accepted keyframe: frontend (node, ICP batch, factors) + solve."""
    return _keyframe_solve(cfg, _keyframe_frontend(cfg, state, ranges), solve_method, solve_bucket)


def _should_process(cfg: DpgConfig, state: SlamState) -> bool:
    """Keyframe gate (shouldProcessLaser, dpg_slam.cc:577-589)."""
    pg = cfg.pose_graph
    angle_gate = geom.angle_dist(state.prev_odom[2], state.odom_at_last_node[2]) > pg.min_angle_between_nodes
    dist_gate = state.cumulative_dist > pg.min_dist_between_nodes
    return bool(state.odom_initialized & (state.first_scan_for_pass | dist_gate | angle_gate))


def _observe_odometry(cfg: DpgConfig, state, odom_pose: torch.Tensor):
    """ObserveOdometry (dpg_slam.cc:515-526), batched over leading lane
    axes: odom_pose (..., 3) against the state's (..., 3) / (...) gate
    fields."""
    moved = torch.linalg.norm(odom_pose[..., 0:2] - state.prev_odom[..., 0:2], dim=-1)
    cum = state.cumulative_dist + torch.where(state.odom_initialized, moved, 0.0)
    return state._replace(
        prev_odom=odom_pose,
        cumulative_dist=cum,
        odom_initialized=torch.ones_like(state.odom_initialized),
        odom_at_last_node=torch.where(state.odom_initialized[..., None], state.odom_at_last_node, odom_pose),
    )


def _current_pose(cfg: DpgConfig, state: SlamState) -> torch.Tensor:
    """GetPose: last node pose composed with the pending odometry delta."""
    n = int(state.num_nodes)
    last = state.poses[n - 1] if n > 0 else torch.zeros(3, device=state.poses.device)
    return geom.compose(last, geom.between(state.odom_at_last_node, state.prev_odom))


# ---------------------------------------------------------------------------
# Offline sequence mode
# ---------------------------------------------------------------------------

class _Gate(NamedTuple):
    """The keyframe gate's fields of a SlamState, as a host copy:
    _observe_odometry and _should_process run on it unchanged."""

    prev_odom: torch.Tensor
    odom_at_last_node: torch.Tensor
    cumulative_dist: torch.Tensor
    odom_initialized: torch.Tensor
    first_scan_for_pass: torch.Tensor


def _process_sequence(cfg: DpgConfig, state: SlamState, odometry: np.ndarray, scans: np.ndarray,
                      solve_method: str, pipelined: bool = False, run_dpg: bool = False):
    """A recorded session as one host loop over its scans (the JAX
    package's lax.scan program): odometry update, keyframe gate, capacity
    gate and, on a keyframe, the keyframe step with the solve at full node
    capacity, then, with run_dpg on pass >= 1, a DPG step. Returns (state,
    keyframe mask (T,), info of the last DPG step or None, saturated):
    saturated is True when a scan passed the gate but was dropped for lack
    of node, edge or prior capacity (the online path raises instead).

    The gate runs on a host copy of the state's five gate fields, with the
    online path's own functions (in the CPU's float32 arithmetic, where
    the online path on the card uses the card's), so no scan reads the
    device; the device state takes each odometry update as well. The capacity gate counts
    nodes and priors on the host and reads the edge count only when an
    upper bound on it could overflow.

    pipelined: the solve of keyframe k runs at the next scan, beside the
    frontend of that scan's keyframe, if any, which reads the unsolved
    poses (a one-solve lag); the rows that existed before that frontend
    take the solved poses, and a catch-up solve follows the last scan. It
    runs no DPG."""
    cap = cfg.capacity
    N = state.poses.shape[0]
    edges_worst = 2 + cfg.pose_graph.max_loop_closures_per_node
    dev = state.poses.device
    odom_dev = torch.as_tensor(odometry, device=dev)
    scans_dev = torch.as_tensor(scans, device=dev)
    odom_host = torch.as_tensor(odometry)
    gate = _Gate(*(getattr(state, f).cpu() for f in _Gate._fields))
    n_nodes, n_priors = int(state.num_nodes), int(state.graph.num_priors)
    edges_hi = int(state.graph.num_edges)  # an upper bound on the device count
    rows = torch.arange(N, device=dev)[:, None]
    kf_mask = np.zeros(len(scans), bool)
    saturated = pending = False
    run_dpg = run_dpg and int(state.pass_number) >= 1  # a sequence stays in one pass
    info = None
    for t in range(len(scans)):
        state = _observe_odometry(cfg, state, odom_dev[t])
        gate = _observe_odometry(cfg, gate, odom_host[t])
        do_kf = _should_process(cfg, gate)
        if do_kf:
            if edges_hi + edges_worst > cap.max_edges:
                edges_hi = int(state.graph.num_edges)
            first = bool(gate.first_scan_for_pass)
            capacity_ok = (
                n_nodes < cap.max_nodes
                and edges_hi + edges_worst <= cap.max_edges
                and (not first or n_priors < cap.max_priors)
            )
            saturated |= not capacity_ok
            do_kf = capacity_ok
        if pipelined:
            solved = _keyframe_solve(cfg, state, solve_method).poses if pending else None
            if do_kf:
                state = _keyframe_frontend(cfg, state, scans_dev[t])
            if solved is not None:
                state = state._replace(poses=torch.where(rows < n_nodes, solved, state.poses))
            pending = do_kf
        elif do_kf:
            state = _keyframe_step(cfg, state, scans_dev[t], solve_method)
            if run_dpg:
                state, info = change_detection.execute_dpg(cfg, state)
        if do_kf:
            kf_mask[t] = True
            n_nodes += 1
            n_priors += int(first)
            edges_hi += edges_worst
            gate = gate._replace(
                odom_at_last_node=gate.prev_odom,
                cumulative_dist=torch.zeros_like(gate.cumulative_dist),
                first_scan_for_pass=torch.zeros_like(gate.first_scan_for_pass),
            )
    if pending:
        state = _keyframe_solve(cfg, state, solve_method)
    return state, kf_mask, info, saturated


# ---------------------------------------------------------------------------
# Reoptimize (pass boundary)
# ---------------------------------------------------------------------------

def _reoptimize_pairs(cfg: DpgConfig, state: SlamState):
    """The full reoptimize pair set (successive + top-K closures per node,
    dpg_slam.cc:83-106) as flat (N*(1+K),) tensors: (flat_src, flat_tgt,
    flat_valid, seeds, flat_gate)."""
    pg = cfg.pose_graph
    N = state.poses.shape[0]
    K = pg.max_loop_closures_per_node
    dev = state.poses.device
    node_mask = state.node_mask
    idx = torch.arange(N, device=dev)

    succ_valid = node_mask & (idx > 0)
    dist = torch.linalg.norm(state.poses[:, None, 0:2] - state.poses[None, :, 0:2], dim=-1)
    same_pass = state.pass_ids[:, None] == state.pass_ids[None, :]
    thr = torch.where(
        same_pass,
        pg.maximum_node_dist_within_pass_scan_comparison,
        pg.maximum_node_dist_across_passes_scan_comparison,
    )
    gap_ok = ~same_pass | ((idx[:, None] - idx[None, :]) >= pg.min_loop_closure_node_gap)
    cand_ok = (
        node_mask[:, None] & node_mask[None, :]
        & (idx[None, :] < (idx[:, None] - 1)) & (dist <= thr) & gap_ok
    )
    cand_idx = _top_k_ascending(torch.where(cand_ok, dist, float("inf")), K)
    cand_valid = torch.gather(cand_ok, 1, cand_idx)

    tgt_idx_all = torch.cat([torch.clamp(idx - 1, min=0)[:, None], cand_idx], dim=1)
    pair_valid = torch.cat([succ_valid[:, None], cand_valid], dim=1)
    flat_src = torch.repeat_interleave(idx, 1 + K)
    flat_tgt = tgt_idx_all.reshape(-1)
    flat_valid = pair_valid.reshape(-1)
    seeds = geom.between(state.poses[flat_tgt], state.poses[flat_src])
    # Successive pairs are well-seeded; closures take the reoptimize gate.
    flat_is_succ = (torch.arange(flat_src.shape[0], device=dev) % (1 + K)) == 0
    flat_gate = torch.where(flat_is_succ, 1.0, pg.reoptimize_gate_multiplier).to(torch.float32)
    return flat_src, flat_tgt, flat_valid, seeds, flat_gate


def _reoptimize_valid_host(cfg: DpgConfig, poses, pass_ids, node_mask) -> np.ndarray:
    """Numpy replica of _reoptimize_pairs' validity: slot k of node i is
    live iff k < min(K, #valid candidates), because the stable ascending
    top-k orders every finite-score candidate before the inf ones."""
    pg = cfg.pose_graph
    N = poses.shape[0]
    K = pg.max_loop_closures_per_node
    idx = np.arange(N)
    succ_valid = node_mask & (idx > 0)
    dist = np.linalg.norm(poses[:, None, 0:2] - poses[None, :, 0:2], axis=-1)
    same_pass = pass_ids[:, None] == pass_ids[None, :]
    thr = np.where(
        same_pass,
        pg.maximum_node_dist_within_pass_scan_comparison,
        pg.maximum_node_dist_across_passes_scan_comparison,
    )
    gap_ok = ~same_pass | ((idx[:, None] - idx[None, :]) >= pg.min_loop_closure_node_gap)
    cand_ok = (
        node_mask[:, None] & node_mask[None, :]
        & (idx[None, :] < (idx[:, None] - 1)) & (dist <= thr) & gap_ok
    )
    n_cand = np.minimum(cand_ok.sum(axis=1), K)
    slot_valid = np.arange(K)[None, :] < n_cand[:, None]
    return np.concatenate([succ_valid[:, None], slot_valid], axis=1).reshape(-1)


def _pack_rows(valid: torch.Tensor, start, values: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write the valid rows of `values` into consecutive slots of `out`
    from `start` on, dropping rows past its capacity."""
    pos = start + torch.cumsum(valid.to(torch.int64), 0) - 1
    keep = valid & (pos < out.shape[0])
    out[pos[keep]] = values[keep].to(out.dtype)
    return out


def _reoptimize_pack_graph(cfg, state, flat_src, flat_tgt, flat_valid, transforms, converged, covs):
    """Rebuild the factor graph from the reoptimize ICP results: per-pass
    priors, odometry factors from the odometry log, then observation
    factors. Returns (graph, number of edge candidates)."""
    pg = cfg.pose_graph
    N = state.poses.shape[0]
    K = pg.max_loop_closures_per_node
    dev = state.poses.device
    node_mask = state.node_mask
    idx = torch.arange(N, device=dev)

    prev_pass = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), state.pass_ids[:-1]])
    is_pass_first = node_mask & (state.pass_ids != prev_pass)

    prior_sigmas = torch.tensor(
        [pg.new_pass_x_std_dev, pg.new_pass_y_std_dev, pg.new_pass_theta_std_dev],
        dtype=torch.float32, device=dev,
    )
    P = state.graph.prior_idx.shape[0]
    prior_idx = _pack_rows(is_pass_first, 0, idx, torch.zeros((P,), dtype=torch.int32, device=dev))

    odom_displ = geom.between(torch.roll(state.odom_poses, 1, dims=0), state.odom_poses)
    odo_si = fg.sqrt_info_from_sigmas(_motion_model_sigmas(cfg, odom_displ))
    odo_valid = node_mask & (idx > 0) & ~is_pass_first & pg.odometry_constraints

    n_flat = flat_src.shape[0]
    is_succ = (torch.arange(n_flat, device=dev) % (1 + K)) == 0
    clos_keep = converged
    if pg.closure_consistency_transl is not None:
        clos_tgt = flat_tgt.reshape(N, 1 + K)[:, 1:]
        clos_t = transforms.reshape(N, 1 + K, 3)[:, 1:]
        clos_ok = (flat_valid & converged).reshape(N, 1 + K)[:, 1:]
        voted = _closure_consistency_votes(cfg, state.poses[clos_tgt], clos_t, state.poses, clos_ok)
        clos_keep = torch.cat([converged.reshape(N, 1 + K)[:, :1], voted], dim=1).reshape(-1)
    keep = flat_valid & (is_succ | clos_keep)

    E = state.graph.edge_idx.shape[0]
    num_odo = odo_valid.sum()
    num_edge_candidates = (num_odo + keep.sum()).to(torch.int32)
    edge_idx = torch.zeros((E, 2), dtype=torch.int32, device=dev)
    edge_meas = torch.zeros((E, 3), dtype=torch.float32, device=dev)
    edge_si = torch.zeros((E, 3, 3), dtype=torch.float32, device=dev)
    # Odometry factors first, then observation factors.
    odo_pair = torch.stack([torch.clamp(idx - 1, min=0), idx], dim=1)
    obs_pair = torch.stack([flat_tgt, flat_src], dim=1)
    obs_si = fg.sqrt_info_from_covariance(covs)
    for valid, start, pair, meas, si in (
        (odo_valid, 0, odo_pair, odom_displ, odo_si),
        (keep, num_odo, obs_pair, transforms, obs_si),
    ):
        _pack_rows(valid, start, pair, edge_idx)
        _pack_rows(valid, start, meas, edge_meas)
        _pack_rows(valid, start, si, edge_si)

    graph = fg.FactorGraph(
        prior_idx=prior_idx,
        prior_val=torch.zeros((P, 3), dtype=torch.float32, device=dev),
        prior_sqrt_info=fg.sqrt_info_from_sigmas(prior_sigmas).expand(P, 3, 3).clone(),
        num_priors=is_pass_first.sum().to(torch.int32),
        edge_idx=edge_idx,
        edge_meas=edge_meas,
        edge_sqrt_info=edge_si,
        # Candidates beyond capacity were dropped: clamp the live count so
        # no zero-information slot counts as a factor; the host checks the
        # candidate count for overflow.
        num_edges=torch.clamp(num_edge_candidates, max=E),
    )
    return graph, num_edge_candidates


def _reoptimize_icp_inputs(cfg: DpgConfig, sub: SlamState, compact_idx, compact_valid):
    """The compacted reoptimize ICP sweep's inputs: the enumerated pair set
    gathered at the host-chosen live slots. Returns (pairs, icp_args,
    icp_kwargs, cval) where icp_args/kwargs are icp_align's arguments."""
    pairs = _reoptimize_pairs(cfg, sub)
    flat_src, flat_tgt, flat_valid, seeds, flat_gate = pairs
    csrc = flat_src[compact_idx]
    ctgt = flat_tgt[compact_idx]
    cval = compact_valid & flat_valid[compact_idx]
    args = (
        sub.cloud[csrc],
        sub.cloud_mask[csrc] & cval[:, None],
        sub.cloud[ctgt],
        sub.cloud_mask[ctgt] & cval[:, None],
        seeds[compact_idx],
        cfg.pose_graph,
    )
    kwargs = dict(tgt_normals=sub.cloud_normals[ctgt], gate_multiplier=flat_gate[compact_idx])
    return pairs, args, kwargs, cval


def _reoptimize_bucket(state: SlamState, nb: int) -> SlamState:
    """The state with its node fields sliced to the bucket [:nb]."""
    return state._replace(**{f: getattr(state, f)[:nb] for f in _NODE_FIELDS})


def _reoptimize_graph(cfg: DpgConfig, sub: SlamState, pairs, compact_idx, cval, res: icp.ICPResult):
    """The reoptimize's factor graph from its ICP sweep on the bucketed
    state `sub`: the compacted results scattered back over the enumerated
    pairs, the graph rebuilt from scratch. Returns (graph, number of edge
    candidates).

    Slots the compaction did not cover keep their seed transform with
    converged=False and the fixed covariance (successive factors degrade
    to the odometry-consistent measurement; closures are dropped)."""
    pg = cfg.pose_graph
    flat_src, flat_tgt, flat_valid, seeds, _ = pairs
    n_flat = flat_src.shape[0]
    live = compact_idx[cval]
    transforms = seeds.clone()
    transforms[live] = res.transform[cval]
    converged = torch.zeros((n_flat,), dtype=torch.bool, device=seeds.device)
    converged[live] = res.converged[cval]
    fixed = torch.tensor(
        [pg.laser_x_variance, pg.laser_y_variance, pg.laser_theta_variance],
        dtype=torch.float32, device=seeds.device,
    )
    covs = torch.diag(fixed).expand(n_flat, 3, 3).clone()
    covs[live] = res.covariance[cval]

    return _reoptimize_pack_graph(cfg, sub, flat_src, flat_tgt, flat_valid, transforms, converged, covs)


def _reoptimize_solve_kwargs(cfg: DpgConfig, solve_method: str) -> dict:
    """The reoptimize's cold LM solve settings (fg.solve / fg.solve_lanes)."""
    pg = cfg.pose_graph
    return dict(
        # Ours, capped by the reference's GTSAM iteration cap.
        max_iterations=min(pg.gn_max_iterations, pg.gtsam_max_iterations),
        damping_init=pg.gn_damping_init,
        method=solve_method,
        robust_delta=pg.robust_delta,
        rel_tol=pg.gn_tol,
    )


def _reoptimize(cfg: DpgConfig, state: SlamState, compact_idx, compact_valid, solve_method: str, nb: int):
    """Global re-alignment at a pass boundary (reoptimize,
    dpg_slam.cc:35-120) on the node bucket [:nb]: the compacted ICP sweep
    over the live pairs (_reoptimize_icp_inputs, one icp_align call), the
    graph rebuilt (_reoptimize_graph), a full LM solve on the bucket.
    Returns (full-capacity poses, graph, number of edge candidates)."""
    sub = _reoptimize_bucket(state, nb)
    pairs, args, kwargs, cval = _reoptimize_icp_inputs(cfg, sub, compact_idx, compact_valid)
    res = icp.icp_align(*args, **kwargs)
    graph, n_edge_cand = _reoptimize_graph(cfg, sub, pairs, compact_idx, cval, res)
    poses_b, _ = fg.solve(sub.poses, graph, sub.node_mask, **_reoptimize_solve_kwargs(cfg, solve_method))
    return torch.cat([poses_b, state.poses[nb:]]), graph, n_edge_cand


def _reoptimize_compaction_host(cfg: DpgConfig, poses, pass_ids, n_nodes: int, nb: int, pad_unit: int = 64):
    """Live-pair compaction of the reoptimize sweep on the host:
    (compact_idx int64, compact_valid bool, n_live), successive pairs
    first, padded with invalid slots to a multiple of `pad_unit`."""
    K = cfg.pose_graph.max_loop_closures_per_node
    valid = _reoptimize_valid_host(cfg, poses, pass_ids, np.arange(nb) < n_nodes)
    live = np.nonzero(valid)[0]
    is_succ = (live % (1 + K)) == 0
    order = np.concatenate([live[is_succ], live[~is_succ]])
    B = max(pad_unit, -(-len(order) // pad_unit) * pad_unit)
    idx = np.zeros((B,), np.int64)
    idx[: len(order)] = order
    val = np.zeros((B,), bool)
    val[: len(order)] = True
    return idx, val, len(order)


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------

class DpgSlamEngine:
    """Host-side session engine.

    Usage:
      eng = DpgSlamEngine(DpgConfig())   # on the card; device="cpu" for the CPU
      for odom, ranges in dataset:
          eng.observe_odometry(odom)
          eng.observe_laser(ranges)   # on pass >= 1 also a DPG step
      eng.increment_pass()            # session boundary: global reoptimize
      traj = eng.trajectory()
      layers = eng.map_layers()       # DPG map layers as host arrays
    """

    def __init__(self, config: DpgConfig | None = None, device="cuda", mesh=None):
        """config: default DpgConfig(), as in the JAX package. mesh:
        optional parallel.mesh.Mesh; the pass-boundary reoptimize then runs
        parallel.distributed_reoptimize over its shards (the keyframe path
        is unchanged)."""
        config = config if config is not None else DpgConfig()
        self.config = config
        self.device = torch.device(device)
        self.state = _init_state(config, self.device)
        # Dense Cholesky up to ~1k nodes; CG beyond.
        self.solve_method = "dense" if config.capacity.max_nodes <= 1024 else "cg"
        self._dpg_enabled = True
        self.last_dpg_info = None
        self._coverage_warned_pass = -1
        self.mesh = mesh
        if mesh is not None and config.capacity.max_edges % mesh.size != 0:
            raise ValueError(
                f"max_edges ({config.capacity.max_edges}) must divide by the mesh "
                f"size ({mesh.size}) for the distributed solve"
            )

    def _solve_bucket(self, n_needed: int) -> int:
        """Smallest power-of-two node bucket >= n_needed (min 64, capped at
        capacity)."""
        b = 64
        while b < n_needed:
            b *= 2
        return min(b, self.config.capacity.max_nodes)

    def _incremental_method(self, bucket: int) -> str:
        """Per-keyframe linear solver: Cholesky up to 256 nodes, dense PCG
        above."""
        if self.solve_method != "dense":
            return self.solve_method
        return "dense" if bucket <= 256 else "dense_cg"

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -- observations -----------------------------------------------------
    def observe_odometry(self, odom_pose) -> None:
        """Absolute odometry pose [x, y, theta]."""
        self.state = _observe_odometry(self.config, self.state, self._tensor(odom_pose))

    def observe_odometry_relative(self, delta) -> None:
        """Relative odometry (dx, dy, dtheta) in the robot frame."""
        self.state = _observe_odometry(
            self.config, self.state, geom.compose(self.state.prev_odom, self._tensor(delta))
        )

    def process_sequence(self, odometry, scans, run_dpg: bool | None = None, pipelined: bool = False) -> np.ndarray:
        """Offline mode: a whole recorded session, (T, 3) absolute odometry
        and (T, num_beams) scans, in one call; returns the (T,) keyframe
        mask. The keyframes are the online loop's; the per-keyframe solve
        runs at full node capacity, as in the JAX package. Where capacity
        runs out, later keyframes are dropped with a warning (the online
        path raises). run_dpg (default: the engine's DPG setting) runs a
        DPG step after each keyframe on pass >= 1; last_dpg_info takes the
        last one's info. pipelined: see _process_sequence (implies no
        DPG)."""
        odometry = np.asarray(odometry, np.float32)
        scans = np.asarray(scans, np.float32)
        B = self.config.scan.num_beams
        if scans.ndim != 2 or scans.shape[1] != B:
            raise ValueError(f"expected (T, {B}) scans, got {scans.shape}")
        if odometry.shape != (scans.shape[0], 3):
            raise ValueError(f"expected ({scans.shape[0]}, 3) odometry, got {odometry.shape}")
        dpg = (self._dpg_enabled if run_dpg is None else run_dpg) and not pipelined
        with profiling.job():
            self.state, kf_mask, info, saturated = _process_sequence(
                self.config, self.state, odometry, scans,
                self._incremental_method(self.config.capacity.max_nodes), pipelined, dpg,
            )
        if info is not None:
            self.last_dpg_info = info
        if saturated:
            cap = self.config.capacity
            warnings.warn(
                f"process_sequence: keyframe(s) dropped at capacity (nodes {self.num_nodes()}/"
                f"{cap.max_nodes}, edges {int(self.state.graph.num_edges)}/{cap.max_edges}, "
                f"priors {int(self.state.graph.num_priors)}/{cap.max_priors}); raise CapacityParams",
                RuntimeWarning, stacklevel=2,
            )
        return kf_mask

    def observe_laser(self, ranges) -> bool:
        """One lidar scan; returns True if a keyframe was created."""
        ranges = self._tensor(ranges)
        if ranges.shape != (self.config.scan.num_beams,):
            raise ValueError(
                f"expected ({self.config.scan.num_beams},) ranges, got {tuple(ranges.shape)}"
            )
        if not _should_process(self.config, self.state):
            return False
        n = int(self.state.num_nodes)
        if n >= self.config.capacity.max_nodes:
            raise RuntimeError("node capacity exhausted; raise CapacityParams.max_nodes")
        edges_worst_case = 2 + self.config.pose_graph.max_loop_closures_per_node
        if int(self.state.graph.num_edges) + edges_worst_case > self.config.capacity.max_edges:
            raise RuntimeError("edge capacity exhausted; raise CapacityParams.max_edges")
        bucket = self._solve_bucket(n + 1)
        with profiling.job():
            self.state = _keyframe_step(
                self.config, self.state, ranges, self._incremental_method(bucket), solve_bucket=bucket
            )
            if self._dpg_enabled and int(self.state.pass_number) >= 1:
                self._execute_dpg()
        return True

    def increment_pass(self) -> None:
        """Session boundary: bump the pass counter and reoptimize globally
        (incrementPassNumber + reoptimize, dpg_slam.cc:25-120), over the
        mesh's shards when the engine has one."""
        if int(self.state.pass_number) + 1 >= self.config.capacity.max_passes:
            raise RuntimeError(
                f"pass capacity exhausted: {int(self.state.pass_number) + 1} "
                f">= capacity.max_passes={self.config.capacity.max_passes}"
            )
        s = self.state
        self.state = s._replace(
            pass_number=s.pass_number + 1,
            odom_initialized=torch.zeros_like(s.odom_initialized),
            first_scan_for_pass=torch.ones_like(s.first_scan_for_pass),
            cumulative_dist=torch.zeros_like(s.cumulative_dist),
        )
        if int(self.state.num_nodes) > 1:
            with profiling.job():
                if self.mesh is not None:
                    from dpg_slam_tpu_torch.parallel.distributed import distributed_reoptimize

                    self.state = distributed_reoptimize(self.mesh, self.config, self.state)
                else:
                    self.state = self._reoptimize_now(self.state)

    def _reoptimize_now(self, state: SlamState) -> SlamState:
        """Reoptimize on the live node bucket with the sweep compacted to
        the live pairs (host-side validity, _reoptimize_valid_host)."""
        n_nodes = int(state.num_nodes)
        nb = self._solve_bucket(n_nodes)
        compact_idx, compact_valid, n_live = _reoptimize_compaction_host(
            self.config,
            state.poses[:nb].cpu().numpy(),
            state.pass_ids[:nb].cpu().numpy(),
            n_nodes,
            nb,
        )
        poses, graph, n_edge_cand = _reoptimize(
            self.config, state,
            torch.as_tensor(compact_idx, device=self.device),
            torch.as_tensor(compact_valid, device=self.device),
            self.solve_method, nb,
        )
        # Candidates <= odometry factors (< live nodes) + live ICP pairs, so
        # the device count is read only when that bound can overflow.
        if n_nodes - 1 + n_live > self.config.capacity.max_edges:
            self._check_edge_overflow(int(n_edge_cand))
        return state._replace(poses=poses, graph=graph)

    def _check_edge_overflow(self, n_edge_candidates: int) -> None:
        """Fail loudly when reoptimize produced more factor candidates than
        the edge capacity holds (the overflow was dropped)."""
        E = self.config.capacity.max_edges
        if n_edge_candidates > E:
            raise RuntimeError(
                f"reoptimize produced {n_edge_candidates} factor candidates "
                f"but edge capacity is {E}; raise CapacityParams.max_edges "
                f"(>= max_nodes * (2 + max_loop_closures_per_node))"
            )

    def _execute_dpg(self) -> None:
        self.state, self.last_dpg_info = change_detection.execute_dpg(self.config, self.state)
        # The submap holds at most max_submap_nodes contributors: surface
        # the reference's unmet-coverage warning (dpg_slam.cc:697-699),
        # once a pass.
        threshold = self.config.dpg.current_pose_graph_coverage_threshold
        pass_no = int(self.state.pass_number)
        if pass_no != self._coverage_warned_pass:
            coverage = float(self.last_dpg_info.coverage)
            if coverage < threshold:
                self._coverage_warned_pass = pass_no
                mode = "coverage-growth" if self.config.dpg.submap_coverage_growth else "nearest"
                logger.warning(
                    "DPG submap coverage %.2f below threshold %.2f for pass %d (submap capped at %d %s contributors)",
                    coverage, threshold, pass_no, self.config.dpg.max_submap_nodes, mode,
                )

    def map_layers(self) -> dict:
        """The four DPG map layers as host arrays: name -> (P, 2) points."""
        layers = change_detection.map_layers(self.config, self.state)
        return {name: pts.cpu().numpy()[mask.cpu().numpy()] for name, (pts, mask) in layers.items()}

    def occupancy_grid(self, center=None, extent: int = 512, include_inactive: bool = False):
        """Dense occupancy grid of the session (toOccGridMsg analog):
        ((extent, extent) int8 UNKNOWN=0 / FREE=1 / OCCUPIED=2, world origin
        (2,)), centered on the keyframes' mean position by default."""
        if center is None:
            center = self.state.poses[: max(self.num_nodes(), 1), :2].cpu().numpy().mean(axis=0)
        grid, origin = change_detection.occupancy_snapshot(
            self.config, self.state, self._tensor(center), extent=extent, include_inactive=include_inactive
        )
        return grid.cpu().numpy(), origin.cpu().numpy()

    def map_points(self, subsample: int | None = None) -> np.ndarray:
        """All valid scan points in the map frame, thinned (GetMap,
        dpg_slam.cc:555-575)."""
        sub = subsample or self.config.viz.display_points_fraction
        n = self.num_nodes()
        if n == 0:
            return np.zeros((0, 2))
        pts_bl = scan.points_in_base_link(
            self.state.ranges[:n], self.config.scan, _laser_pose_in_bl(self.config, self.device)
        )
        pts_map = geom.apply(self.state.poses[:n, None, :], pts_bl)
        valid = scan.valid_mask(self.state.labels[:n])
        return pts_map.reshape(-1, 2).cpu().numpy()[valid.reshape(-1).cpu().numpy()][::sub]

    # -- queries ----------------------------------------------------------
    def pose(self) -> np.ndarray:
        """Current pose estimate incl. un-incorporated odometry (GetPose)."""
        return _current_pose(self.config, self.state).cpu().numpy()

    def trajectory(self) -> np.ndarray:
        """(num_nodes, 3) optimized keyframe poses."""
        return self.state.poses[: self.num_nodes()].cpu().numpy()

    def odom_trajectory(self) -> np.ndarray:
        return self.state.odom_poses[: self.num_nodes()].cpu().numpy()

    def num_nodes(self) -> int:
        return int(self.state.num_nodes)
