"""Scan measurement model — the port of dpg_slam_tpu/scan.py.

A scan is a ``(num_beams,)`` float32 range tensor; labels are int8.
Point labels use the reference enum values (dpg_measurement.h:21):
  STATIC=0, ADDED=1, REMOVED=2, NOT_YET_LABELED=3, MAX_RANGE=4
"""

from __future__ import annotations

import torch

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.config import ScanParams

STATIC = 0
ADDED = 1
REMOVED = 2
NOT_YET_LABELED = 3
MAX_RANGE = 4

__all__ = [
    "STATIC",
    "ADDED",
    "REMOVED",
    "NOT_YET_LABELED",
    "MAX_RANGE",
    "beam_angles",
    "initial_labels",
    "sector_ids",
    "valid_mask",
    "points_in_laser_frame",
    "points_in_base_link",
    "downsample",
]


def beam_angles(params: ScanParams, device) -> torch.Tensor:
    """(num_beams,) beam angles: angle_min + i * angle_increment."""
    i = torch.arange(params.num_beams, dtype=torch.float32, device=device)
    return params.angle_min + i * params.angle_increment


def initial_labels(ranges: torch.Tensor, params: ScanParams) -> torch.Tensor:
    """MAX_RANGE where the reading is >= range_max, < range_min or not
    finite (dpg_measurement.h:43-45), else NOT_YET_LABELED; int8."""
    invalid = (
        (ranges >= params.range_max)
        | (ranges < params.range_min)
        | ~torch.isfinite(ranges)
    )
    return torch.where(invalid, MAX_RANGE, NOT_YET_LABELED).to(torch.int8)


def sector_ids(params: ScanParams, num_sectors: int, device) -> torch.Tensor:
    """(num_beams,) int32 sector of each beam (dpg_slam.cc:501-505)."""
    points_per_sector = params.num_beams / num_sectors
    i = torch.arange(params.num_beams, dtype=torch.float32, device=device)
    sec = torch.floor(i / points_per_sector).to(torch.int32)
    return torch.clamp(sec, max=num_sectors - 1)


def valid_mask(labels: torch.Tensor) -> torch.Tensor:
    """Points that exist as geometry: everything but MAX_RANGE."""
    return labels != MAX_RANGE


def points_in_laser_frame(ranges: torch.Tensor, params: ScanParams) -> torch.Tensor:
    """(..., num_beams) ranges -> (..., num_beams, 2) laser-frame points."""
    a = beam_angles(params, ranges.device)
    return torch.stack([ranges * torch.cos(a), ranges * torch.sin(a)], dim=-1)


def points_in_base_link(
    ranges: torch.Tensor, params: ScanParams, laser_pose_in_bl: torch.Tensor
) -> torch.Tensor:
    """Scan points in the base_link frame (laser extrinsic applied)."""
    return geom.apply(laser_pose_in_bl, points_in_laser_frame(ranges, params))


def downsample(
    points: torch.Tensor, valid: torch.Tensor, ratio: int, max_points: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep every `ratio`-th beam and pad/truncate to `max_points`
    (zeros / False). Returns (..., max_points, 2) and (..., max_points)."""
    pts = points[..., ::ratio, :]
    msk = valid[..., ::ratio]
    n = pts.shape[-2]
    if n >= max_points:
        return pts[..., :max_points, :], msk[..., :max_points]
    pad_n = max_points - n
    pad_pts = pts.new_zeros(pts.shape[:-2] + (pad_n, 2))
    pad_msk = msk.new_zeros(msk.shape[:-1] + (pad_n,))
    return torch.cat([pts, pad_pts], dim=-2), torch.cat([msk, pad_msk], dim=-1)
