"""SE(2) geometry on tensors, batched over leading axes — the port of
dpg_slam_tpu/geom.py.

A pose is a ``(..., 3)`` tensor ``[x, y, theta]``; a point set is
``(..., 2)``. Semantics match the reference helpers (math_utils.{h,cc})
and the JAX package function for function.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "wrap_angle",
    "angle_dist",
    "angle_diff",
    "compose",
    "inverse",
    "between",
    "apply",
    "inv_apply",
    "inv_sym3",
    "constant",
]

_TWO_PI = 2.0 * math.pi


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def constant(values, device) -> torch.Tensor:
    """A float32 tensor of fixed values on `device`, made once per device
    and values: a host-to-device copy waits for the stream, so paths that
    must not read the host build their constants here. Read-only."""
    return _constant(tuple(float(v) for v in values), torch.device(device))


def inv_sym3(H: torch.Tensor) -> torch.Tensor:
    """Closed-form (cofactor) inverse of symmetric 3x3 matrices, batched
    over leading axes; singular blocks (|det| <= 1e-30) map to zeros."""
    a00 = H[..., 0, 0]
    a01 = H[..., 0, 1]
    a02 = H[..., 0, 2]
    a11 = H[..., 1, 1]
    a12 = H[..., 1, 2]
    a22 = H[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    safe = det.abs() > 1e-30
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, torch.ones_like(det)), 0.0)
    cof = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c01, c11, c12], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    return cof * inv_det[..., None, None]


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi]: subtract the round-half-to-even multiple
    of 2π (C rint, math_utils.h:14; torch.round rounds half to even)."""
    return angle - _TWO_PI * torch.round(angle / _TWO_PI)


def angle_diff(a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """Signed wrapped difference a0 - a1."""
    return wrap_angle(a0 - a1)


def angle_dist(a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """Absolute wrapped distance between angles."""
    return angle_diff(a0, a1).abs()


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SE(2) composition a ∘ b: ``compose(world_T_a, a_T_b) = world_T_b``."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """SE(2) inverse: if a = world_T_frame then inverse(a) = frame_T_world."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    th = wrap_angle(-a[..., 2])
    return torch.stack([x, y, th], dim=-1)


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose of b in a's frame: a⁻¹ ∘ b (BetweenFactor prediction)."""
    return compose(inverse(a), b)


def _rot_and_t(pose: torch.Tensor, points: torch.Tensor):
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    if points.ndim > pose.ndim:  # points carry an extra point axis
        return c[..., None], s[..., None], pose[..., None, 0:2]
    return c, s, pose[..., 0:2]


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply pose(s) to point(s): R(θ) p + t. Pose (..., 3) broadcasts
    with points (..., P, 2) or (..., 2)."""
    c, s, t = _rot_and_t(pose, points)
    x = c * points[..., 0] - s * points[..., 1]
    y = s * points[..., 0] + c * points[..., 1]
    return torch.stack([x, y], dim=-1) + t


def inv_apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply the inverse of pose(s) to point(s): R(-θ)(p - t)."""
    c, s, t = _rot_and_t(pose, points)
    dx = points[..., 0] - t[..., 0]
    dy = points[..., 1] - t[..., 1]
    x = c * dx + s * dy
    y = -s * dx + c * dy
    return torch.stack([x, y], dim=-1)
