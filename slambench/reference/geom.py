"""SE(2) helpers of the plain reference (float32 torch, elementwise)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even):
    what a tensor core reads of a float32 operand with TF32 on."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), i.view(torch.float32), x)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def wrap(a: torch.Tensor) -> torch.Tensor:
    return a - TWO_PI * torch.round(a / TWO_PI)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                        wrap(a[..., 2] + b[..., 2])], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(ca * a[..., 0] + sa * a[..., 1]), -(-sa * a[..., 0] + ca * a[..., 1]), wrap(-a[..., 2])], dim=-1)


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return compose(inverse(a), b)


def apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R(theta) p + t; pose (..., 3) against points (..., P, 2)."""
    c, s = torch.cos(pose[..., 2])[..., None], torch.sin(pose[..., 2])[..., None]
    return torch.stack([c * pts[..., 0] - s * pts[..., 1] + pose[..., None, 0],
                        s * pts[..., 0] + c * pts[..., 1] + pose[..., None, 1]], dim=-1)


def inv_apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R(-theta)(p - t); pose (..., 3) against points (..., P, 2)."""
    c, s = torch.cos(pose[..., 2])[..., None], torch.sin(pose[..., 2])[..., None]
    dx, dy = pts[..., 0] - pose[..., None, 0], pts[..., 1] - pose[..., None, 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def inv3(H: torch.Tensor) -> torch.Tensor:
    """Cofactor inverse of symmetric 3 x 3 blocks; singular blocks give 0."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a11, a12, a22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    c00, c01, c02 = a11 * a22 - a12 * a12, a02 * a12 - a01 * a22, a01 * a12 - a02 * a11
    c11, c12, c22 = a00 * a22 - a02 * a02, a01 * a02 - a00 * a12, a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    safe = det.abs() > 1e-30
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, torch.ones_like(det)), 0.0)
    cof = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c01, c11, c12], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return cof * inv_det[..., None, None]
