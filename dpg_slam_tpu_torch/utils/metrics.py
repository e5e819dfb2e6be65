"""Trajectory evaluation metrics (numpy) — a jax-free copy of
dpg_slam_tpu/utils/metrics.py: ATE and RPE."""

from __future__ import annotations

import numpy as np

__all__ = ["ate_rmse", "align_se2", "relative_pose_error", "to_anchor_frame"]


def to_anchor_frame(traj: np.ndarray, anchor: np.ndarray | None = None) -> np.ndarray:
    """Express a (T, 3) trajectory relative to an anchor pose (default: its
    own first pose), as the engine anchors every pass at the origin."""
    traj = np.asarray(traj, np.float64)
    a = traj[0] if anchor is None else np.asarray(anchor, np.float64)
    c, s = np.cos(a[2]), np.sin(a[2])
    d = traj[:, :2] - a[:2]
    out = np.empty_like(traj)
    out[:, 0] = c * d[:, 0] + s * d[:, 1]
    out[:, 1] = -s * d[:, 0] + c * d[:, 1]
    out[:, 2] = np.angle(np.exp(1j * (traj[:, 2] - a[2])))
    return out


def align_se2(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Best-fit SE(2) alignment of est positions onto ref (no scale)."""
    p = est[:, :2]
    q = ref[:, :2]
    mp, mq = p.mean(0), q.mean(0)
    H = (p - mp).T @ (q - mq)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, d]) @ U.T
    return p @ R.T + (mq - R @ mp)


def ate_rmse(est: np.ndarray, ref: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error (position RMSE), in the shared anchored
    frame unless align=True."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if est.shape[0] != ref.shape[0]:
        raise ValueError(f"trajectory lengths differ: {est.shape} vs {ref.shape}")
    p = align_se2(est, ref) if align else est[:, :2]
    err = p - ref[:, :2]
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def relative_pose_error(est: np.ndarray, ref: np.ndarray) -> float:
    """RPE: RMSE of the per-step relative translation error."""
    def rels(x):
        d = x[1:, :2] - x[:-1, :2]
        c, s = np.cos(x[:-1, 2]), np.sin(x[:-1, 2])
        return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)

    de = rels(np.asarray(est, np.float64)) - rels(np.asarray(ref, np.float64))
    return float(np.sqrt(np.mean(np.sum(de * de, axis=1))))
