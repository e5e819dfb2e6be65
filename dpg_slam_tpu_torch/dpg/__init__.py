"""Dynamic pose graph layer: multi-pass change detection and map pruning
(the port of dpg_slam_tpu/dpg)."""

from dpg_slam_tpu_torch.dpg.change_detection import (
    execute_dpg,
    map_layers,
    occupancy_snapshot,
)

__all__ = ["execute_dpg", "map_layers", "occupancy_snapshot"]
