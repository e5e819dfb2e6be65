"""The benchmark's traffic generator: a frozen copy of the port's
simulator (dpg_slam_tpu_torch/io/dataset.py: the office world, its loop
and simulate_sequence), so that a change to the program cannot move the
yardstick.

``simulate_sessions`` makes many sessions over one world and one
trajectory. The ground-truth trajectory and its raycast do not depend on
the seed, so they are computed once and every session only draws its own
scan and odometry noise; each session equals ``simulate_sequence`` on the
same seed (slambench/tests/test_slambench_sim.py holds the two together).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Sequence(NamedTuple):
    scans: np.ndarray         # (T, num_beams) float32 ranges
    odometry: np.ndarray      # (T, 3) float32 absolute odometry (drifting frame)
    ground_truth: np.ndarray  # (T, 3) float32 true poses


class ScanGeometry(NamedTuple):
    num_beams: int
    angle_min: float
    angle_max: float
    range_min: float
    range_max: float

    @property
    def angle_increment(self) -> float:
        return (self.angle_max - self.angle_min) / (self.num_beams - 1.0)


def box(cx: float, cy: float, w: float, h: float) -> np.ndarray:
    x0, x1 = cx - w / 2, cx + w / 2
    y0, y1 = cy - h / 2, cy + h / 2
    return np.array([[x0, y0, x1, y0], [x1, y0, x1, y1], [x1, y1, x0, y1], [x0, y1, x0, y0]])


def office_world(boxes=()) -> np.ndarray:
    """(S, 4) wall segments of the 16 x 12 m office, with a desk and a
    cabinet, plus any (cx, cy, w, h) boxes, in that order."""
    segs = np.array([
        [-8, -6, 8, -6], [8, -6, 8, 6], [8, 6, -8, 6], [-8, 6, -8, -6],
        [-8, 0, -3, 0], [-1, 0, 3, 0], [5, 0, 8, 0],
        [0, -6, 0, -3], [0, -1, 0, 0],
        [4, 2, 4, 6], [4, 2, 6, 2],
    ], dtype=np.float64)
    parts = [segs, box(-5.0, -2.2, 1.2, 0.8), box(7.2, -3.2, 1.0, 1.0)]
    parts += [box(*b) for b in boxes]
    return np.vstack(parts)


def office_loop_waypoints(laps: int = 1) -> np.ndarray:
    """The loop through the office rooms, `laps` times."""
    wps = np.array([
        [-6, -4], [-2, -4], [-2, -2], [2, -2], [2, -4], [6, -4],
        [6, -2], [6, 3], [2, 3], [-2, 3], [-6, 3], [-6, -1], [-6, -4],
    ], dtype=np.float64)
    return np.vstack([wps] + [wps[1:]] * (laps - 1))


def raycast(segments: np.ndarray, pose: np.ndarray, params: ScanGeometry) -> np.ndarray:
    """Ranges (num_beams,) from a laser pose, clipped to range_max."""
    i = np.arange(params.num_beams)
    angles = params.angle_min + i * params.angle_increment + pose[2]
    ox, oy = pose[0], pose[1]
    dx, dy = np.cos(angles), np.sin(angles)
    x1, y1, x2, y2 = segments.T
    ex, ey = x2 - x1, y2 - y1
    denom = dx[:, None] * (-ey)[None, :] + dy[:, None] * ex[None, :]
    rx = x1[None, :] - ox
    ry = y1[None, :] - oy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rx * (-ey)[None, :] + ry * ex[None, :]) / denom
        u = (dx[:, None] * ry - dy[:, None] * rx) / denom
    hit = (np.abs(denom) > 1e-12) & (t > params.range_min) & (u >= 0.0) & (u <= 1.0)
    ranges = np.where(hit, t, np.inf).min(axis=1)
    return np.minimum(ranges, params.range_max).astype(np.float32)


def interp_trajectory(waypoints: np.ndarray, step: float) -> np.ndarray:
    """Piecewise-linear poses through waypoints, heading along motion."""
    poses = []
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        d = np.linalg.norm(b - a)
        heading = np.arctan2(b[1] - a[1], b[0] - a[0])
        n = max(int(d / step), 1)
        for k in range(n):
            p = a + (k / n) * (b - a)
            poses.append([p[0], p[1], heading])
    poses.append([waypoints[-1][0], waypoints[-1][1], poses[-1][2]])
    return np.array(poses)


def _laser_pose(robot_pose, laser_pose_in_bl):
    lx, ly, lth = laser_pose_in_bl
    c, s = np.cos(robot_pose[2]), np.sin(robot_pose[2])
    return np.array([robot_pose[0] + c * lx - s * ly, robot_pose[1] + s * lx + c * ly, robot_pose[2] + lth])


def _noisy_session(clean: np.ndarray, gt: np.ndarray, params: ScanGeometry, seed, scan_noise: float,
                   odom_noise_transl: float, odom_noise_rot: float) -> Sequence:
    """One session's noise on the shared clean ranges, in simulate_sequence's
    order of draws: every scan's beams first, then per step two
    translation draws and one rotation draw."""
    rng = np.random.default_rng(seed)
    T = len(gt)
    hit = clean < params.range_max
    noise = rng.normal(0, scan_noise, (T, params.num_beams))
    scans = np.minimum(np.where(hit, clean + noise, clean), params.range_max).astype(np.float32)
    odom = np.zeros((T, 3))
    odom[0] = gt[0]
    for t in range(1, T):
        c, s = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        d = gt[t, :2] - gt[t - 1, :2]
        rel = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], np.angle(np.exp(1j * (gt[t, 2] - gt[t - 1, 2])))])
        rel[:2] += rng.normal(0, odom_noise_transl, 2)
        rel[2] += rng.normal(0, odom_noise_rot)
        c, s = np.cos(odom[t - 1, 2]), np.sin(odom[t - 1, 2])
        odom[t, 0] = odom[t - 1, 0] + c * rel[0] - s * rel[1]
        odom[t, 1] = odom[t - 1, 1] + s * rel[0] + c * rel[1]
        odom[t, 2] = np.angle(np.exp(1j * (odom[t - 1, 2] + rel[2])))
    return Sequence(scans=scans, odometry=odom.astype(np.float32), ground_truth=gt.astype(np.float32))


def simulate_sessions(segments: np.ndarray, waypoints: np.ndarray, params: ScanGeometry, seeds, *,
                      step: float = 0.25, odom_noise_transl: float = 0.004, odom_noise_rot: float = 0.002,
                      scan_noise: float = 0.01, laser_pose_in_bl=(0.2, 0.0, 0.0)) -> list[Sequence]:
    """One session per seed through the same world and waypoints."""
    gt = interp_trajectory(np.asarray(waypoints, np.float64), step)
    clean = np.stack([raycast(segments, _laser_pose(p, laser_pose_in_bl), params) for p in gt])
    return [_noisy_session(clean, gt, params, s, scan_noise, odom_noise_transl, odom_noise_rot) for s in seeds]


def simulate_sequence(segments, waypoints, params: ScanGeometry, *, seed: int = 0, **kw) -> Sequence:
    """One session (simulate_sessions of one seed)."""
    return simulate_sessions(segments, waypoints, params, [seed], **kw)[0]
