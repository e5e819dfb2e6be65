"""Occupancy-grid rasterization as dense tensor ops — the port of
dpg_slam_tpu/ops/raster.py.

A grid window is (H, W) int8, UNKNOWN=0 < FREE=1 < OCCUPIED=2, anchored at
`origin` (world coords of cell [0, 0]) with `resolution` meters a cell;
cell = round(p / res) - round(origin / res). "Occupied beats free" and
grid combination are elementwise max.

The JAX package drops out-of-window writes (``mode="drop"``). Here every
grid carries one spare row and column: a dropped write goes to the spare
cell, which is sliced off, so no write needs a mask read on the host. All
writes of one call set the same constant (FREE, then OCCUPIED), so
duplicate cells agree, and writing FREE before OCCUPIED gives the JAX
package's max-combine.
"""

from __future__ import annotations

import torch

from dpg_slam_tpu_torch import geom

__all__ = [
    "UNKNOWN", "FREE", "OCCUPIED", "world_to_cell", "in_window", "rasterize_scans",
    "rasterize_endpoints",
]

UNKNOWN = 0
FREE = 1
OCCUPIED = 2


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as the JAX package divides. On the card torch
    turns a division by a Python number into a product with its
    reciprocal, which can differ in the last bit; a device constant keeps
    it a division."""
    return x / geom.constant([c], x.device)


def world_to_cell(points: torch.Tensor, origin: torch.Tensor, resolution: float) -> torch.Tensor:
    """(..., 2) world points -> (..., 2) int32 cell indices of the window
    at `origin`: round(p / res) (half to even) less round(origin / res)."""
    rc = torch.round(true_div(points, resolution)).to(torch.int32)
    oc = torch.round(true_div(origin, resolution)).to(torch.int32)
    return rc - oc


def in_window(cells: torch.Tensor, extent: int) -> torch.Tensor:
    return (cells[..., 0] >= 0) & (cells[..., 0] < extent) & (cells[..., 1] >= 0) & (cells[..., 1] < extent)


def spare_index(cells: torch.Tensor, ok: torch.Tensor, extent: int) -> torch.Tensor:
    """(..., 2) cells and (...) write mask -> (...) int64 flat index into an
    (extent + 1, extent + 1) window; masked writes land on the spare cell
    (extent, extent)."""
    w = extent + 1
    x = torch.where(ok, cells[..., 0], extent).to(torch.int64)
    y = torch.where(ok, cells[..., 1], extent).to(torch.int64)
    return x * w + y


def _grid_offsets(G: int, extent: int, device) -> torch.Tensor:
    """(G,) int64 flat offset of each grid of a (G, extent + 1, extent + 1) stack."""
    return torch.arange(G, device=device, dtype=torch.int64) * (extent + 1) ** 2


def ray_cells(laser_poses, points_map, origin, resolution: float, march_steps: int):
    """(G, B, S, 2) cells of the FREE march: t in {0, 1/S, ..., (S-1)/S},
    point = laser + t * (end - laser). origin: (2,) or (G, 1, 2)."""
    dev = points_map.device
    t = true_div(torch.arange(march_steps, dtype=torch.float32, device=dev), float(march_steps))
    t = t[None, None, :, None]
    start = laser_poses[:, None, None, 0:2]
    end = points_map[:, :, None, :]
    if origin.ndim > 1:
        origin = origin[:, None]
    return world_to_cell(start + t * (end - start), origin, resolution)


def fill_at(grid: torch.Tensor, flat_idx: torch.Tensor, value) -> torch.Tensor:
    return grid.view(-1).index_fill_(0, flat_idx.reshape(-1), value).view(grid.shape)


def rasterize_endpoints(
    points_map: torch.Tensor,     # (G, B, 2) scan endpoints in map frame
    occupied_mask: torch.Tensor,  # (G, B)
    origin: torch.Tensor,         # (2,), or (G, 1, 2): one window per grid
    extent: int,
    resolution: float,
) -> torch.Tensor:
    """OCCUPIED-endpoint-only rasterization: (G, extent, extent) int8 with
    endpoint cells OCCUPIED, everything else UNKNOWN."""
    G = points_map.shape[0]
    dev = points_map.device
    grid = torch.zeros((G, extent + 1, extent + 1), dtype=torch.int8, device=dev)
    cells = world_to_cell(points_map, origin, resolution)
    idx = spare_index(cells, occupied_mask & in_window(cells, extent), extent)
    fill_at(grid, idx + _grid_offsets(G, extent, dev)[:, None], OCCUPIED)
    return grid[:, :extent, :extent]


def rasterize_scans(
    laser_poses: torch.Tensor,    # (G, 3) lidar pose in map frame per grid
    points_map: torch.Tensor,     # (G, B, 2) scan endpoints in map frame
    ranges: torch.Tensor,         # (G, B) beam ranges
    occupied_mask: torch.Tensor,  # (G, B) endpoint marks an OCCUPIED cell
    free_ray_mask: torch.Tensor,  # (G, B) beam marches FREE cells
    origin: torch.Tensor,         # (2,) world position of cell [0, 0], or (G, 1, 2) per grid
    extent: int,
    resolution: float,
    march_steps: int,
) -> torch.Tensor:
    """Rasterize G scans into G dense occupancy windows: every beam in
    `free_ray_mask` marches FREE cells from the laser toward its endpoint,
    beams in `occupied_mask` mark their endpoint cell OCCUPIED, and
    OCCUPIED wins over FREE wins over UNKNOWN. Returns (G, extent, extent)
    int8."""
    G = points_map.shape[0]
    dev = points_map.device
    grid = torch.zeros((G, extent + 1, extent + 1), dtype=torch.int8, device=dev)
    offsets = _grid_offsets(G, extent, dev)
    rc = ray_cells(laser_poses, points_map, origin, resolution, march_steps)
    free_idx = spare_index(rc, free_ray_mask[:, :, None] & in_window(rc, extent), extent)
    fill_at(grid, free_idx + offsets[:, None, None], FREE)
    cells = world_to_cell(points_map, origin, resolution)
    occ_idx = spare_index(cells, occupied_mask & in_window(cells, extent), extent)
    fill_at(grid, occ_idx + offsets[:, None], OCCUPIED)
    return grid[:, :extent, :extent]
