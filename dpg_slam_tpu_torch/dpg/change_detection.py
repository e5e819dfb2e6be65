"""DPG change detection — the port of dpg_slam_tpu/dpg/change_detection.py.

One DPG step (``execute_dpg``, the reference's executeDPG) compares the
current pose chain (the last C keyframes of this pass) with a submap of
prior-pass keyframes near it:

  1. the chain, and a world-anchored window at its centroid;
  2. the submap contributors (M nearest, or the greedy coverage growth),
     and optionally a local re-registration of the chain scans to the
     submap's points (ops.icp.icp_align: kernel K1 on the card);
  3. ADDED candidates (chain points in submap free space) and REMOVED
     candidates (submap points in chain free space), with the margin and
     persistence vetoes; FREE is the polar point test, OCCUPIED dense
     endpoint grids (ops.raster);
  4. the angular-bin commit gate per chain node;
  5. the label commits;
  6. the sector punch-through of committed REMOVED points, then node
     deactivation.

``execute_dpg_lanes`` runs the step on every lane of a stacked state (a
leading lane axis S, the batched modes' layout) with every lane's work in
the same tensors: one K1 launch for all lanes' local registrations, each
lane's grids in its own window, each lane's tables with their own spare
row. ``execute_dpg`` is its S = 1 case.

Everything is fixed-shape tensor work on the device of the state: no
step reads a value on the host. The JAX package's ``mode="drop"``
scatters write to a spare row, bin or cell that is sliced off, and its
``lax.top_k`` orders become stable sorts (ties go to the lower index).
The deviations from the reference that the JAX package documents hold
here unchanged (NOT_YET_LABELED rasterizes as STATIC, the submap is the
M nearest in-radius nodes unless ``submap_coverage_growth``, the bin
ratio is a real division, REMOVED labels go to the owning node).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dpg_slam_tpu_torch import geom, scan
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.ops import icp, raster
from dpg_slam_tpu_torch.ops.raster import true_div
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["execute_dpg", "execute_dpg_lanes", "map_layers", "occupancy_snapshot", "DpgStepInfo"]

# Fixed capacity of the compacted REMOVED points the sector punch-through
# tests against every past node (JAX: change_detection._PUNCH_MAX_POINTS).
# Points past it in one step are dropped that step; their labels persist,
# so later steps punch them.
_PUNCH_MAX_POINTS = 1024
# Ray points a chunk of occupancy_snapshot's FREE march holds (each takes
# ~30 bytes of temporaries: 52 M of them at 256 nodes x 1,024 beams x 200
# steps).
_SNAPSHOT_CHUNK_POINTS = 1 << 24


class DpgStepInfo(NamedTuple):
    """Diagnostics of one DPG step: 0-dim device tensors from execute_dpg,
    (S,) tensors, one entry a lane, from execute_dpg_lanes."""

    num_added: torch.Tensor         # int32 newly labeled ADDED points
    num_removed: torch.Tensor       # int32 newly labeled REMOVED points
    coverage: torch.Tensor          # float32 chain coverage by the submap
    num_contributors: torch.Tensor  # int32 submap nodes used


# The state fields a DPG step reads, each with a leading lane axis in the
# lane form.
_DPG_FIELDS = (
    "poses", "pass_ids", "node_active", "ranges", "labels", "sector_active", "cloud", "cloud_mask",
    "num_nodes", "pass_number",
)


def _smallest_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last dimension, ties to
    the lower index (lax.top_k's order on -score)."""
    return torch.argsort(score, dim=-1, stable=True)[..., :k]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane rows: x (S, N, ...) at idx (S, K) -> (S, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Length of (..., 2) vectors as sqrt(x² + y²) (jnp.linalg.norm's sum)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _lidar_poses(cfg: DpgConfig, poses: torch.Tensor) -> torch.Tensor:
    pg = cfg.pose_graph
    laser = geom.constant(
        [pg.laser_x_in_bl_frame, pg.laser_y_in_bl_frame, pg.laser_orientation_rel_bl_frame], poses.device
    )
    return geom.compose(poses, laser.expand(poses.shape))


def _scan_points_map(cfg: DpgConfig, lidar: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(..., G, 3) lidar poses and (..., G, B) ranges -> (..., G, B, 2)
    map-frame endpoints."""
    return geom.apply(lidar[..., None, :], scan.points_in_laser_frame(ranges, cfg.scan))


def _grid_origins(origin: torch.Tensor, G: int) -> torch.Tensor:
    """Each lane's window origin (S, 2) for its G grids: (S·G, 1, 2)."""
    S = origin.shape[0]
    return origin[:, None, None, :].expand(S, G, 1, 2).reshape(S * G, 1, 2)


def _endpoint_grids(points, occupied, origin, extent: int, res: float) -> torch.Tensor:
    """raster.rasterize_endpoints over (S, G, B, 2) points, every grid in
    its lane's window: (S, G, extent, extent)."""
    S, G, B = occupied.shape
    grids = raster.rasterize_endpoints(
        points.reshape(S * G, B, 2), occupied.reshape(S * G, B), _grid_origins(origin, G), extent, res
    )
    return grids.reshape(S, G, extent, extent)


def _scan_grids(lidar, points, ranges, occupied, free, origin, extent: int, res: float, march: int):
    """raster.rasterize_scans over (S, G, ...) scans, every grid in its
    lane's window: (S, G, extent, extent)."""
    S, G, B = ranges.shape
    flat = lambda x: x.reshape((S * G,) + x.shape[2:])  # noqa: E731
    grids = raster.rasterize_scans(
        flat(lidar), flat(points), flat(ranges), flat(occupied), flat(free), _grid_origins(origin, G), extent, res,
        march,
    )
    return grids.reshape(S, G, extent, extent)


def _dilate_occupied(grid: torch.Tensor, margin: int) -> torch.Tensor:
    """(..., H, W) int8 grid -> bool mask of cells within `margin` cells of
    an OCCUPIED cell: a separable max-pool of the 0/1 mask with zero
    padding (max_pool2d pads with -inf, the same for a 0/1 mask)."""
    occ = grid == raster.OCCUPIED
    if margin <= 0:
        return occ
    k = 2 * margin + 1
    x = occ.reshape(-1, 1, *grid.shape[-2:]).to(torch.float32)
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(margin, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, margin))
    return (x > 0.5).reshape(grid.shape)


def _beam_select(cfg: DpgConfig, labels: torch.Tensor, sector_active: torch.Tensor):
    """Reference beam-inclusion rule (dpg_slam.cc:977-1008) at its default
    include flags, NOT_YET_LABELED as STATIC. Returns (included, occupied):
    beams that march free rays, and beams whose endpoint is OCCUPIED."""
    sec = scan.sector_ids(cfg.scan, cfg.dpg.num_sectors, labels.device)
    beam_sector_active = sector_active[..., sec.long()]
    label_ok = (
        (labels == scan.MAX_RANGE)
        | (labels == scan.STATIC)
        | (labels == scan.NOT_YET_LABELED)
        | (labels == scan.ADDED)
        | (labels == scan.REMOVED)
    )
    included = beam_sector_active & label_ok
    return included, included & (labels != scan.MAX_RANGE)


def _polar_free_at(
    cfg: DpgConfig,
    lidar_poses: torch.Tensor,  # (..., G, 3) lidar pose per source scan
    ranges: torch.Tensor,       # (..., G, B)
    beam_mask: torch.Tensor,    # (..., G, B) beams that march free space
    points: torch.Tensor,       # (..., Q, 2) map-frame query points
    slack: float,
) -> torch.Tensor:
    """(..., G, Q) bool: the query point's cell center lies in scan g's
    marched free space — its bearing's nearest beam is selected, the beam's
    ray passes within half a cell of it (cross-track) and it is short of
    the beam's return by `slack` (along-track)."""
    res = cfg.dpg.occ_grid_resolution
    points = torch.round(true_div(points, res)) * res
    rel = geom.inv_apply(lidar_poses[..., :, None, :], points[..., None, :, :])
    r = _norm2(rel)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    amin, inc = cfg.scan.angle_min, cfg.scan.angle_increment
    B = ranges.shape[-1]
    b = torch.round(true_div(ang - amin, inc)).to(torch.int32)
    infov = (b >= 0) & (b <= B - 1)
    bc = torch.clamp(b, 0, B - 1).long()
    rg = torch.gather(ranges, -1, bc)
    mk = torch.gather(beam_mask, -1, bc)
    dphi = ang - (amin + bc.to(ang.dtype) * inc)
    cross_ok = dphi.abs() * r <= 0.5 * res + 1e-6
    return infov & mk & cross_ok & (r <= rg - slack)


def _coverage_growth_select(cfg: DpgConfig, states, contrib_ok, score, chain_lidar, chain_pts_map,
                            chain_ranges, chain_occ, chain_incl, origin):
    """Coverage-driven contributor selection (getSubMapCoveringCurrPoseChain,
    dpg_slam.cc:622-701), per lane: the max_submap_candidates nearest
    in-radius nodes are rasterized once on a grid coarsened by
    coverage_coarse_factor, and a greedy max-cover loop of M steps picks,
    each step, the candidate with the largest gain in covered chain cells,
    or nothing once coverage reaches the threshold. Returns (contrib_idx
    (S, M), contrib_valid (S, M))."""
    dpg = cfg.dpg
    M = dpg.max_submap_nodes
    P_pool = max(dpg.max_submap_candidates, M)
    f = dpg.coverage_coarse_factor
    res = dpg.occ_grid_resolution
    c_extent = max(1, dpg.grid_extent_cells // f)
    c_res = res * f
    c_march = max(1, int(round(cfg.scan.range_max / res)) // f)

    pool_idx = _smallest_k(score, P_pool)
    pool_valid = torch.gather(contrib_ok, 1, pool_idx)
    chain_grids_c = _scan_grids(
        chain_lidar, chain_pts_map, chain_ranges, chain_occ, chain_incl, origin, c_extent, c_res, c_march
    )
    chain_known_c = torch.amax(chain_grids_c, dim=1) > raster.UNKNOWN  # (S, H, W)
    total = torch.clamp(chain_known_c.sum(dim=(1, 2)), min=1)

    pool_lidar = _lidar_poses(cfg, _rows(states.poses, pool_idx))
    pool_ranges = _rows(states.ranges, pool_idx)
    pool_pts = _scan_points_map(cfg, pool_lidar, pool_ranges)
    pool_incl, pool_occ = _beam_select(cfg, _rows(states.labels, pool_idx), _rows(states.sector_active, pool_idx))
    pool_grids_c = _scan_grids(
        pool_lidar, pool_pts, pool_ranges, pool_occ & pool_valid[..., None], pool_incl & pool_valid[..., None],
        origin, c_extent, c_res, c_march,
    )
    pool_known = (pool_grids_c > raster.UNKNOWN) & chain_known_c[:, None]

    threshold = dpg.current_pose_graph_coverage_threshold
    lane = torch.arange(score.shape[0], device=score.device)
    ids = torch.arange(P_pool, device=score.device)
    covered = torch.zeros_like(chain_known_c)
    picked = torch.zeros(pool_idx.shape, dtype=torch.bool, device=score.device)
    sel = []
    for _ in range(M):
        gains = (pool_known & ~covered[:, None]).sum(dim=(2, 3))
        gains = torch.where(pool_valid & ~picked, gains, -1)
        best = torch.argmax(gains, dim=-1)  # the first of equal gains, as jnp.argmax
        take = (gains.amax(dim=-1) > 0) & (covered.sum(dim=(1, 2)) / total < threshold)
        picked = picked | ((ids == best[:, None]) & take[:, None])
        covered = covered | (pool_known[lane, best] & take[:, None, None])
        sel.append(torch.where(take, best, -1))
    sel = torch.stack(sel, dim=1)
    return torch.gather(pool_idx, 1, torch.clamp(sel, min=0)), sel >= 0


def _changed_bins(cfg: DpgConfig, chain_lidar, points, valid) -> torch.Tensor:
    """(..., C, n_bins) bool: bearing bins, in each chain node's lidar
    frame, of its changed points (chain_lidar (..., C, 3), points (..., C,
    Q, 2), valid (..., C, Q))."""
    n_bins = cfg.dpg.num_bins_for_change_detection
    amin, amax = cfg.scan.angle_min, cfg.scan.angle_max
    rel = geom.inv_apply(chain_lidar, points)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ok = valid & (ang >= amin) & (ang <= amax)
    b = torch.clamp(true_div(ang - amin, (amax - amin) / n_bins).to(torch.int32), 0, n_bins - 1)
    b = torch.where(ok, b, n_bins).long()
    G = valid.shape[:-1]
    rows = torch.arange(G.numel(), device=points.device).view(G + (1,)) * (n_bins + 1)
    hist = torch.zeros(G + (n_bins + 1,), dtype=torch.bool, device=points.device)
    return raster.fill_at(hist, b + rows, True)[..., :n_bins]


def execute_dpg(cfg: DpgConfig, state):
    """Run change detection for the current pose chain of one session.
    Returns (new_state, DpgStepInfo); new_state carries new labels,
    sector_active and node_active tensors, and the input state is left as
    it was. This is execute_dpg_lanes on a lane axis of one."""
    lanes, info = execute_dpg_lanes(cfg, state._replace(**{f: getattr(state, f)[None] for f in _DPG_FIELDS}))
    new = state._replace(labels=lanes.labels[0], sector_active=lanes.sector_active[0],
                         node_active=lanes.node_active[0])
    return new, DpgStepInfo(*(x[0] for x in info))


def execute_dpg_lanes(cfg: DpgConfig, states):
    """One DPG step on every lane of a stacked state: the fields of
    _DPG_FIELDS carry a leading lane axis S (poses (S, N, 3), num_nodes
    (S,), pass_number (S,), ...) and each lane's step is the one-session
    step on its own state. All lanes' local registrations go through one
    icp_align call of S·C pairs. Returns (new_states, DpgStepInfo of (S,)
    tensors); new_states carries new labels, sector_active and node_active
    tensors, and the input is left as it was."""
    with profiling.span("dpg.step"):
        dpg = cfg.dpg
        C = dpg.current_pose_chain_len
        M = dpg.max_submap_nodes
        extent = dpg.grid_extent_cells
        res = dpg.occ_grid_resolution
        B = cfg.scan.num_beams
        L, N = states.poses.shape[:2]
        NS = dpg.num_sectors
        dev = states.poses.device
        pool = max(dpg.max_submap_candidates, M) if dpg.submap_coverage_growth else M
        if pool > N:
            raise ValueError(f"DPG picks {pool} submap candidates from {N} node slots: raise "
                             f"capacity.max_nodes or lower dpg.max_submap_nodes / max_submap_candidates")
        with profiling.span("dpg.chain"):
            lane = torch.arange(L, device=dev)
            l3 = lane.view(L, 1, 1)
            idx = torch.arange(N, device=dev)
            node_mask = idx < states.num_nodes[:, None]
            pass_no = states.pass_number[:, None]

            # ---- 1. Current pose chain: the last <= C nodes of the current pass.
            chain_idx = states.num_nodes[:, None].long() - 1 - torch.arange(C, device=dev)  # newest first
            chain_valid = (chain_idx >= 0) & (_rows(states.pass_ids, torch.clamp(chain_idx, min=0)) == pass_no)
            chain_idx = torch.clamp(chain_idx, min=0)
            chain_poses = _rows(states.poses, chain_idx)  # (S, C, 3)
            chain_lidar = _lidar_poses(cfg, chain_poses)
            chain_ranges = _rows(states.ranges, chain_idx)
            centroid = torch.where(chain_valid[..., None], chain_poses[..., 0:2], 0.0).sum(1) / torch.clamp(
                chain_valid.sum(1), min=1
            )[:, None]
            origin = centroid - 0.5 * extent * res  # (S, 2): each lane's window
            window = origin[:, None, None, :]        # against (S, G, B, 2) points
            pts_laser = scan.points_in_laser_frame(chain_ranges, cfg.scan)
            chain_pts_map = geom.apply(chain_lidar[..., None, :], pts_laser)  # (S, C, B, 2)
            chain_incl, chain_occ = _beam_select(cfg, _rows(states.labels, chain_idx),
                                                 _rows(states.sector_active, chain_idx))
            chain_incl = chain_incl & chain_valid[..., None]
            chain_occ = chain_occ & chain_valid[..., None]

            # ---- 2. Submap contributors: active prior-pass nodes within the
            # proximity radius of a chain node.
            prior_pass = node_mask & (states.pass_ids != pass_no) & states.node_active
            d_chain = _norm2(states.poses[:, :, None, 0:2] - chain_poses[:, None, :, 0:2])  # (S, N, C)
            d_min = torch.where(chain_valid[:, None, :], d_chain, float("inf")).amin(dim=2)
            contrib_ok = prior_pass & (d_min <= dpg.distance_threshold_for_local_submap_nodes)
            score = torch.where(contrib_ok, d_min, float("inf"))
            if dpg.submap_coverage_growth:
                contrib_idx, contrib_valid = _coverage_growth_select(
                    cfg, states, contrib_ok, score, chain_lidar, chain_pts_map, chain_ranges, chain_occ, chain_incl,
                    origin,
                )
            else:
                contrib_idx = _smallest_k(score, M)
                contrib_valid = torch.gather(contrib_ok, 1, contrib_idx)

            sub_lidar = _lidar_poses(cfg, _rows(states.poses, contrib_idx))  # (S, M, 3)
            sub_ranges = _rows(states.ranges, contrib_idx)
            sub_pts_map = _scan_points_map(cfg, sub_lidar, sub_ranges)  # (S, M, B, 2)
            sub_incl, sub_occ = _beam_select(cfg, _rows(states.labels, contrib_idx),
                                             _rows(states.sector_active, contrib_idx))
            sub_incl = sub_incl & contrib_valid[..., None]
            sub_occ = sub_occ & contrib_valid[..., None]
            sub_pts_flat = sub_pts_map.reshape(L, M * B, 2)

        with profiling.span("dpg.register"):
            # ---- 2b. Local re-registration of each chain scan to its lane's
            # submap occupied points (strided to local_reg_max_points targets); the
            # graph poses are untouched, and a refinement is kept only within 6
            # cells. Every lane's C pairs go into one icp_align call.
            if dpg.local_registration:
                reg_pg = dataclasses.replace(
                    cfg.pose_graph, icp_maximum_iterations=min(12, cfg.pose_graph.icp_maximum_iterations)
                )
                T = dpg.local_reg_max_points
                stride = max(1, (M * B) // T)
                tgt_pts = sub_pts_flat[:, ::stride][:, :T]
                tgt_ok = sub_occ.reshape(L, M * B)[:, ::stride][:, :T]
                pad_t = T - tgt_pts.shape[1]
                if pad_t:
                    tgt_pts = torch.cat([tgt_pts, tgt_pts.new_zeros((L, pad_t, 2))], dim=1)
                    tgt_ok = torch.cat([tgt_ok, tgt_ok.new_zeros((L, pad_t))], dim=1)

                def pairs(x):  # (S, C, ...) -> (S·C, ...)
                    return x.reshape((L * C,) + x.shape[2:])

                reg = icp.icp_align(
                    pairs(_rows(states.cloud, chain_idx)),
                    pairs(_rows(states.cloud_mask, chain_idx) & chain_valid[..., None]),
                    pairs(tgt_pts[:, None].expand(L, C, T, 2)),
                    pairs(tgt_ok[:, None].expand(L, C, T)),
                    pairs(chain_poses),
                    reg_pg,
                    gate_multiplier=torch.ones((L * C,), dtype=torch.float32, device=dev),
                )
                transform = reg.transform.view(L, C, 3)
                shift = _norm2(transform[..., 0:2] - chain_poses[..., 0:2])
                ok = reg.converged.view(L, C) & (shift <= 6.0 * res)
                chain_poses = torch.where(ok[..., None], transform, chain_poses)
                chain_lidar = _lidar_poses(cfg, chain_poses)
                chain_pts_map = geom.apply(chain_lidar[..., None, :], pts_laser)

        with profiling.span("dpg.grids"):
            # OCCUPIED as dense endpoint grids: the chain's (C, H, W) and ONE grid
            # for the whole submap, per lane; FREE is never rasterized
            # (_polar_free_at).
            chain_occ_grids = _endpoint_grids(chain_pts_map, chain_occ, origin, extent, res)  # (S, C, H, W)
            submap_occ_grid = _endpoint_grids(sub_pts_flat[:, None], sub_occ.reshape(L, 1, M * B), origin, extent,
                                              res)[:, 0]

            # Coverage diagnostic: the share of the chain's sampled endpoints that
            # some contributor observed (slack -res reaches through the return).
            chain_pts_flat = chain_pts_map.reshape(L, C * B, 2)
            sub_known_at_chain = _polar_free_at(cfg, sub_lidar, sub_ranges, sub_incl, chain_pts_flat, -res)
            sub_known_at_chain = sub_known_at_chain.any(dim=1).reshape(L, C, B)
            chain_sampled = (chain_incl | chain_occ) & chain_valid[..., None]
            coverage = (chain_sampled & sub_known_at_chain).sum(dim=(1, 2)) / torch.clamp(
                chain_sampled.sum(dim=(1, 2)), min=1
            )

        with profiling.span("dpg.candidates"):
            # ---- 3. Change candidates. ADDED: a chain point in submap free space
            # (at least min_free_views contributors saw through it), off submap
            # structure and outside its margin.
            chain_cells = raster.world_to_cell(chain_pts_map, window, res)
            chain_inw = raster.in_window(chain_cells, extent)
            ccx = torch.clamp(chain_cells[..., 0], 0, extent - 1).long()
            ccy = torch.clamp(chain_cells[..., 1], 0, extent - 1).long()
            free_votes_m = _polar_free_at(cfg, sub_lidar, sub_ranges, sub_incl, chain_pts_flat, res)  # (S, M, C*B)
            sub_free_votes = free_votes_m.sum(dim=1).reshape(L, C, B)
            sub_occ_at_chain = submap_occ_grid[l3, ccx, ccy] == raster.OCCUPIED
            sub_occ_near = _dilate_occupied(submap_occ_grid, dpg.change_margin_cells)
            added_cand = (
                chain_occ
                & chain_inw
                & (sub_free_votes >= max(dpg.min_free_views, 1))
                & ~sub_occ_at_chain
                & ~sub_occ_near[l3, ccx, ccy]
            )

            # REMOVED: a submap point in a chain node's free space, off chain
            # structure and outside its margin. The grids are gathered at explicit
            # (lane, chain node, x, y) indices.
            sub_cells = raster.world_to_cell(sub_pts_map, window, res)
            sub_inw = raster.in_window(sub_cells, extent)
            scx = torch.clamp(sub_cells[..., 0], 0, extent - 1).long()
            scy = torch.clamp(sub_cells[..., 1], 0, extent - 1).long()
            chain_free_at_sub = _polar_free_at(cfg, chain_lidar, chain_ranges, chain_incl, sub_pts_flat, res)
            chain_free_at_sub = chain_free_at_sub.reshape(L, C, M, B)
            at_sub = (lane.view(L, 1, 1, 1), torch.arange(C, device=dev).view(1, C, 1, 1), scx[:, None], scy[:, None])
            chain_occ_at_sub = chain_occ_grids[at_sub] == raster.OCCUPIED  # (S, C, M, B)
            occ_near_any = _dilate_occupied(chain_occ_grids, dpg.change_margin_cells)[at_sub].any(dim=1)
            removed_cand = (
                (sub_occ & sub_inw)[:, None]
                & chain_free_at_sub
                & ~chain_occ_at_sub
                & ~occ_near_any[:, None]
            )

            # Whole-object consistency: veto candidates next to PERSISTENT submap
            # structure (occupied cells that are not candidates themselves).
            cand_any = removed_cand.any(dim=1)
            cand_cells = torch.zeros((L, extent + 1, extent + 1), dtype=torch.bool, device=dev)
            cand_cells = raster.fill_at(
                cand_cells, raster.spare_index(sub_cells, cand_any, extent) + l3 * (extent + 1) ** 2, True
            )
            persistent = (submap_occ_grid == raster.OCCUPIED) & ~cand_cells[:, :extent, :extent]
            persistent_near = _dilate_occupied(
                torch.where(persistent, raster.OCCUPIED, raster.UNKNOWN).to(torch.int8), dpg.change_margin_cells
            )
            removed_cand = removed_cand & ~persistent_near[l3, scx, scy][:, None]

        with profiling.span("dpg.commit"):
            # ---- 4. Angular-bin commit gate per chain node: commit a node's
            # changes when enough distinct bearing bins changed.
            n_bins = dpg.num_bins_for_change_detection
            changed_bins = _changed_bins(
                cfg, chain_lidar,
                torch.cat([chain_pts_map, sub_pts_flat[:, None].expand(L, C, -1, -1)], dim=2),
                torch.cat([added_cand, removed_cand.reshape(L, C, M * B)], dim=2),
            )
            changed_counts = changed_bins.sum(dim=-1)
            if dpg.replicate_int_bin_ratio:
                ratio = (changed_counts // n_bins).to(torch.float32)  # reference cc:823 (integer division)
            else:
                ratio = true_div(changed_counts.to(torch.float32), float(n_bins))
            has_changes = added_cand.any(dim=-1) | removed_cand.reshape(L, C, -1).any(dim=-1)
            commit = (
                chain_valid
                & has_changes
                & ((ratio >= dpg.delta_change_threshold) | (changed_counts >= dpg.min_changed_bins_for_commit))
            )

            # ---- 5. Commit labels: ADDED on the chain nodes' own points, REMOVED
            # on the owning submap nodes' points. Each lane's table has a spare row
            # N; row r of lane s is flat row s·(N + 1) + r.
            added_commit = added_cand & commit[..., None]                           # (S, C, B)
            removed_commit = (removed_cand & commit[..., None, None]).any(dim=1)    # (S, M, B)
            beam = torch.arange(B, device=dev)
            first_row = l3 * (N + 1)
            labels = torch.cat([states.labels, states.labels.new_zeros((L, 1, B))], dim=1)
            added_rows = first_row + torch.where(added_commit, chain_idx[..., None], N)
            raster.fill_at(labels, added_rows * B + beam, scan.ADDED)
            sub_rows = first_row + torch.where(removed_commit, contrib_idx[..., None], N)
            raster.fill_at(labels, sub_rows * B + beam, scan.REMOVED)

            # Labeling a point REMOVED deactivates its sector in its own node.
            sec = scan.sector_ids(cfg.scan, NS, dev).long()
            sector_active = torch.cat([states.sector_active, states.sector_active.new_zeros((L, 1, NS))], dim=1)
            raster.fill_at(sector_active, sub_rows * NS + sec, False)

        with profiling.span("dpg.punch"):
            # ---- 6. Sector punch-through: each past node whose field of view a
            # committed REMOVED point lies clearly inside (closer than the node's
            # own return by 2 cells) loses that sector. The committed points are
            # compacted first to at most _PUNCH_MAX_POINTS, in index order.
            rvalid_full = removed_commit.reshape(L, M * B)
            top_idx = _smallest_k((~rvalid_full).to(torch.int8), min(_PUNCH_MAX_POINTS, M * B))
            rflat = torch.gather(sub_pts_flat, 1, top_idx[..., None].expand(-1, -1, 2))
            rvalid = torch.gather(rvalid_full, 1, top_idx)
            R = rflat.shape[1]
            amin, amax = cfg.scan.angle_min, cfg.scan.angle_max
            past_nodes = node_mask & (states.pass_ids != pass_no)
            rel = geom.inv_apply(_lidar_poses(cfg, states.poses), rflat[:, None].expand(L, N, R, 2))  # (S, N, R, 2)
            rr = _norm2(rel)
            ang = torch.atan2(rel[..., 1], rel[..., 0])
            in_fov = (rvalid[:, None, :] & past_nodes[..., None] & (rr <= cfg.scan.range_max) & (ang >= amin)
                      & (ang <= amax))
            psec = torch.clamp(true_div(ang - amin, (amax - amin) / NS).to(torch.int32), 0, NS - 1)
            # The field of view's range at the point's bearing: the nearer of the
            # two neighbouring beams' returns (dpg_node.cc:77-84).
            approx = true_div(ang - amin, cfg.scan.angle_increment)
            i0 = torch.clamp(torch.floor(approx).to(torch.int32), 0, B - 1)
            i1 = torch.clamp(i0 + 1, max=B - 1)
            fov_range = torch.minimum(torch.gather(states.ranges, 2, i0.long()),
                                      torch.gather(states.ranges, 2, i1.long()))
            punch = in_fov & (fov_range > rr + 2.0 * res)
            raster.fill_at(sector_active, (first_row + torch.where(punch, idx[:, None], N)) * NS + psec, False)
            labels, sector_active = labels[:, :N], sector_active[:, :N]

            # Node deactivation below the active-sector floor (dpg_node.cc:93-95).
            frac_active = sector_active.to(torch.float32).mean(dim=-1)
            node_active = states.node_active & torch.where(
                past_nodes, frac_active >= dpg.minimum_percent_active_sectors, True
            )

        info = DpgStepInfo(
            num_added=added_commit.sum(dim=(1, 2)).to(torch.int32),
            num_removed=removed_commit.sum(dim=(1, 2)).to(torch.int32),
            coverage=coverage.to(torch.float32),
            num_contributors=contrib_valid.sum(dim=1).to(torch.int32),
        )
        return states._replace(labels=labels, sector_active=sector_active, node_active=node_active), info


def _map_frame_scans(cfg: DpgConfig, state):
    lidar = _lidar_poses(cfg, state.poses)
    return lidar, _scan_points_map(cfg, lidar, state.ranges)


def occupancy_snapshot(cfg: DpgConfig, state, center: torch.Tensor, extent: int = 512,
                       include_inactive: bool = False):
    """Dense occupancy grid of the whole session around `center` (the
    toOccGridMsg analog): (grid (extent, extent) int8, origin (2,)).

    The JAX package rasterizes one grid per node and takes their max; one
    grid written with every node's FREE cells and then every OCCUPIED
    endpoint is the same grid. The ray march runs over chunks of nodes of
    at most _SNAPSHOT_CHUNK_POINTS ray points each."""
    res = cfg.dpg.occ_grid_resolution
    origin = center - 0.5 * extent * res
    N, B = state.ranges.shape
    march = int(round(cfg.scan.range_max / res))
    lidar, pts_map = _map_frame_scans(cfg, state)
    if include_inactive:
        sector_act = torch.ones_like(state.sector_active)
        node_ok = state.node_mask
    else:
        sector_act = state.sector_active
        node_ok = state.node_mask & state.node_active
    incl, occ = _beam_select(cfg, state.labels, sector_act)
    incl = incl & node_ok[:, None]
    occ = occ & node_ok[:, None]

    grid = torch.zeros((extent + 1, extent + 1), dtype=torch.int8, device=state.poses.device)
    step = max(1, _SNAPSHOT_CHUNK_POINTS // (B * march))
    for g in range(0, N, step):
        rc = raster.ray_cells(lidar[g:g + step], pts_map[g:g + step], origin, res, march)
        ok = incl[g:g + step, :, None] & raster.in_window(rc, extent)
        raster.fill_at(grid, raster.spare_index(rc, ok, extent), raster.FREE)
    cells = raster.world_to_cell(pts_map, origin, res)
    raster.fill_at(grid, raster.spare_index(cells, occ & raster.in_window(cells, extent), extent), raster.OCCUPIED)
    return grid[:extent, :extent], origin


def map_layers(cfg: DpgConfig, state) -> dict:
    """The four DPG map layers (getActiveAndDynamicMapPoints, cc:832-863):
    name -> (points (N*B, 2), mask (N*B,)) in the map frame.
      active_static:   STATIC (and NOT_YET_LABELED) points of active nodes
                       and sectors
      active_added:    ADDED points of active nodes and sectors
      dynamic_added:   ADDED points of all nodes
      dynamic_removed: REMOVED points of all nodes
    """
    _, pts_map = _map_frame_scans(cfg, state)
    labels = state.labels
    node_mask = state.node_mask[:, None]
    sec = scan.sector_ids(cfg.scan, cfg.dpg.num_sectors, labels.device).long()
    active_ok = node_mask & state.node_active[:, None] & state.sector_active[:, sec]
    is_static = (labels == scan.STATIC) | (labels == scan.NOT_YET_LABELED)
    is_added = labels == scan.ADDED
    is_removed = labels == scan.REMOVED
    flat = pts_map.reshape(-1, 2)
    return {
        "active_static": (flat, (active_ok & is_static).reshape(-1)),
        "active_added": (flat, (active_ok & is_added).reshape(-1)),
        "dynamic_added": (flat, (node_mask & is_added).reshape(-1)),
        "dynamic_removed": (flat, (node_mask & is_removed).reshape(-1)),
    }
