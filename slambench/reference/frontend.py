"""The frontend's host schedule and node clouds, written plainly: the
keyframe gate over an odometry stream, and a scan's labels,
downsampled base-link cloud, mask and normals."""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import geom

STATIC, ADDED, REMOVED, NOT_YET_LABELED, MAX_RANGE = 0, 1, 2, 3, 4


def keyframe_schedule(pg, odometry: np.ndarray) -> np.ndarray:
    """(T,) bool: the first scan of a pass, then every scan after more
    than min_dist_between_nodes of travelled odometry distance or more
    than min_angle_between_nodes of heading change since the last
    keyframe (shouldProcessLaser, dpg_slam.cc:577-589)."""
    odom = np.asarray(odometry, np.float64)
    mask = np.zeros(len(odom), bool)
    last = prev = None
    cum = 0.0
    for t, o in enumerate(odom):
        if prev is not None:
            cum += float(np.hypot(o[0] - prev[0], o[1] - prev[1]))
        else:
            last = o
        prev = o
        ang = abs(np.angle(np.exp(1j * (o[2] - last[2]))))
        if t == 0 or cum > pg.min_dist_between_nodes or ang > pg.min_angle_between_nodes:
            mask[t] = True
            cum = 0.0
            last = o
    return mask


def keyframe_cap(cfg) -> int:
    """Keyframes a lane keeps of one pass in the batched modes: the node
    capacity, and the worst-case edge budget max_edges // (2 + K)."""
    pg = cfg.pose_graph
    return min(cfg.capacity.max_nodes, cfg.capacity.max_edges // (2 + pg.max_loop_closures_per_node))


def beam_angles(sc, device) -> torch.Tensor:
    inc = (sc.angle_max - sc.angle_min) / (sc.num_beams - 1.0)
    return sc.angle_min + torch.arange(sc.num_beams, dtype=torch.float32, device=device) * inc


def laser_points(ranges: torch.Tensor, sc) -> torch.Tensor:
    a = beam_angles(sc, ranges.device)
    return torch.stack([ranges * torch.cos(a), ranges * torch.sin(a)], dim=-1)


def initial_labels(ranges: torch.Tensor, sc) -> torch.Tensor:
    bad = (ranges >= sc.range_max) | (ranges < sc.range_min) | ~torch.isfinite(ranges)
    return torch.where(bad, MAX_RANGE, NOT_YET_LABELED).to(torch.int8)


def normals(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unit normals of an ordered cloud: the perpendicular of the central
    difference, one-sided where a neighbour is invalid, radial when both
    are; zero on invalid points."""
    nxt, prv = torch.roll(pts, -1, dims=-2), torch.roll(pts, 1, dims=-2)
    n_ok, p_ok = torch.roll(mask, -1, dims=-1)[..., None], torch.roll(mask, 1, dims=-1)[..., None]
    tan = torch.where(n_ok & p_ok, nxt - prv, torch.where(n_ok, nxt - pts, torch.where(p_ok, pts - prv, pts)))
    nrm = torch.stack([-tan[..., 1], tan[..., 0]], dim=-1)
    ln = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    radial = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), min=1e-6)
    unit = torch.where(ln > 1e-6, nrm / torch.clamp(ln, min=1e-6), radial)
    return torch.where(mask[..., None], unit, 0.0)


def prepare_cloud(cfg, ranges: torch.Tensor):
    """(..., B) ranges -> labels, (..., P, 2) base-link cloud (every r-th
    beam, padded or cut to icp_max_points), mask, normals."""
    pg, sc = cfg.pose_graph, cfg.scan
    labels = initial_labels(ranges, sc)
    laser = torch.tensor([pg.laser_x_in_bl_frame, pg.laser_y_in_bl_frame, pg.laser_orientation_rel_bl_frame],
                         device=ranges.device)
    pts = geom.apply(laser.expand(ranges.shape[:-1] + (3,)), laser_points(ranges, sc))
    r, P = pg.downsample_icp_points_ratio, pg.icp_max_points
    pts, mask = pts[..., ::r, :][..., :P, :], (labels != MAX_RANGE)[..., ::r][..., :P]
    pad = P - pts.shape[-2]
    if pad > 0:
        pts = torch.cat([pts, pts.new_zeros(pts.shape[:-2] + (pad, 2))], dim=-2)
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], dim=-1)
    return labels, pts, mask, normals(pts, mask)
