"""Synthetic 2D lidar worlds and sequence simulation (numpy) — a jax-free
copy of dpg_slam_tpu/io/dataset.py: the office world and loop, the
reading-room world and loop (the mit suite's), the raycaster and the
sequence simulator. Same inputs and seed give the same arrays as the JAX
package's module.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from dpg_slam_tpu_torch.config import ScanParams

__all__ = [
    "Sequence",
    "SyntheticWorld",
    "make_office_world",
    "make_reading_room_world",
    "office_loop_waypoints",
    "raycast",
    "reading_room_waypoints",
    "simulate_sequence",
]


class Sequence(NamedTuple):
    """One session: T timesteps of scan + odometry (+ ground truth)."""

    scans: np.ndarray         # (T, num_beams) float32 ranges
    odometry: np.ndarray      # (T, 3) absolute odometry poses (drifting frame)
    ground_truth: np.ndarray  # (T, 3) true poses in world frame


@dataclasses.dataclass
class SyntheticWorld:
    """A 2D world of line segments, (S, 4) rows x1, y1, x2, y2."""

    segments: np.ndarray

    def add_box(self, cx: float, cy: float, w: float, h: float) -> "SyntheticWorld":
        x0, x1 = cx - w / 2, cx + w / 2
        y0, y1 = cy - h / 2, cy + h / 2
        box = np.array([[x0, y0, x1, y0], [x1, y0, x1, y1], [x1, y1, x0, y1], [x0, y1, x0, y0]])
        return SyntheticWorld(np.vstack([self.segments, box]))

    def remove_last_box(self) -> "SyntheticWorld":
        return SyntheticWorld(self.segments[:-4])


def make_office_world() -> SyntheticWorld:
    """A 16x12 'office': outer walls + interior partitions + furniture."""
    segs = [
        [-8, -6, 8, -6], [8, -6, 8, 6], [8, 6, -8, 6], [-8, 6, -8, -6],
        [-8, 0, -3, 0], [-1, 0, 3, 0], [5, 0, 8, 0],
        [0, -6, 0, -3], [0, -1, 0, 0],
        [4, 2, 4, 6], [4, 2, 6, 2],
    ]
    w = SyntheticWorld(np.array(segs, dtype=np.float64))
    w = w.add_box(-5.0, -2.2, 1.2, 0.8)  # desk
    return w.add_box(7.2, -3.2, 1.0, 1.0)  # cabinet


def office_loop_waypoints() -> np.ndarray:
    """A loop through the office rooms that revisits its start."""
    return np.array(
        [
            [-6, -4], [-2, -4], [-2, -2], [2, -2], [2, -4], [6, -4],
            [6, -2], [6, 3], [2, 3], [-2, 3], [-6, 3], [-6, -1], [-6, -4],
        ],
        dtype=np.float64,
    )


def make_reading_room_world() -> SyntheticWorld:
    """A 10x8 single room with a central table cluster, the MIT
    reading-room analog: one room revisited over many short sessions."""
    segs = [
        [-5, -4, 5, -4], [5, -4, 5, 4], [5, 4, -5, 4], [-5, 4, -5, -4],
        # Wall stubs whose tips stay >= 0.4 m clear of the waypoint path (a
        # pose on structure makes the raycaster carve through it).
        [-5, 0, -4.0, 0], [5, 0, 3.9, 0],
    ]
    w = SyntheticWorld(np.array(segs, dtype=np.float64))
    w = w.add_box(0.0, 0.0, 1.6, 1.0)  # central table
    return w.add_box(-3.8, 2.8, 0.8, 0.8)  # shelf


def reading_room_waypoints() -> np.ndarray:
    """A loop around the central table, clear of all structure."""
    return np.array([[-3.5, -2.5], [3.5, -2.5], [3.5, 2.5], [-2.5, 2.5], [-3.5, -2.5]])


def raycast(world: SyntheticWorld, pose: np.ndarray, params: ScanParams) -> np.ndarray:
    """Ranges (num_beams,) from a LASER pose, clipped to range_max."""
    i = np.arange(params.num_beams)
    angles = params.angle_min + i * params.angle_increment + pose[2]
    ox, oy = pose[0], pose[1]
    dx, dy = np.cos(angles), np.sin(angles)
    x1, y1, x2, y2 = world.segments.T
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


def _interp_trajectory(waypoints: np.ndarray, step: float) -> np.ndarray:
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


def simulate_sequence(
    world: SyntheticWorld,
    waypoints: np.ndarray,
    params: ScanParams,
    *,
    step: float = 0.25,
    odom_noise_transl: float = 0.004,
    odom_noise_rot: float = 0.002,
    scan_noise: float = 0.01,
    laser_pose_in_bl: tuple[float, float, float] = (0.2, 0.0, 0.0),
    seed: int = 0,
) -> Sequence:
    """Drive through waypoints: scans raycast from the laser pose, and
    odometry integrated from true relative motion plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    gt = _interp_trajectory(np.asarray(waypoints, np.float64), step)
    T = len(gt)
    lx, ly, lth = laser_pose_in_bl

    def laser_pose(robot_pose):
        c, s = np.cos(robot_pose[2]), np.sin(robot_pose[2])
        return np.array(
            [robot_pose[0] + c * lx - s * ly, robot_pose[1] + s * lx + c * ly, robot_pose[2] + lth]
        )

    def noisy_scan(pose):
        r = raycast(world, laser_pose(pose), params)
        hit = r < params.range_max
        # No-hit beams stay exactly range_max (MAX_RANGE downstream).
        noisy = np.where(hit, r + rng.normal(0, scan_noise, params.num_beams), r)
        return np.minimum(noisy, params.range_max).astype(np.float32)

    scans = np.stack([noisy_scan(gt[t]) for t in range(T)])

    odom = np.zeros((T, 3))
    odom[0] = gt[0]
    for t in range(1, T):
        c, s = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        d = gt[t, :2] - gt[t - 1, :2]
        rel = np.array(
            [
                c * d[0] + s * d[1],
                -s * d[0] + c * d[1],
                np.angle(np.exp(1j * (gt[t, 2] - gt[t - 1, 2]))),
            ]
        )
        rel[:2] += rng.normal(0, odom_noise_transl, 2)
        rel[2] += rng.normal(0, odom_noise_rot)
        c, s = np.cos(odom[t - 1, 2]), np.sin(odom[t - 1, 2])
        odom[t, 0] = odom[t - 1, 0] + c * rel[0] - s * rel[1]
        odom[t, 1] = odom[t - 1, 1] + s * rel[0] + c * rel[1]
        odom[t, 2] = np.angle(np.exp(1j * (odom[t - 1, 2] + rel[2])))

    return Sequence(scans=scans, odometry=odom.astype(np.float32), ground_truth=gt.astype(np.float32))
