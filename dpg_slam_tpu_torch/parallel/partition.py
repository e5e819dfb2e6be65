"""Node->shard partitioning for the distributed Schur solver — a copy of
dpg_slam_tpu/parallel/partition.py (numpy; the port imports nothing of
the JAX package).

`spatial_blocks` assigns co-located nodes (across all passes and laps) to
the same shard by sorting live nodes along a Morton (Z-order) curve over
their positions and chunking the order into equal shard-sized groups, so
loop closures stay intra-shard and only trajectory segments crossing a
region boundary contribute separators.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spatial_blocks", "morton_code"]


def morton_code(qx: np.ndarray, qy: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave the low `bits` of qx/qy into a Z-order code."""
    code = np.zeros(qx.shape, np.int64)
    for b in range(bits):
        code |= ((qx >> b) & 1) << (2 * b)
        code |= ((qy >> b) & 1) << (2 * b + 1)
    return code


def spatial_blocks(positions: np.ndarray, node_mask: np.ndarray, n_shards: int) -> np.ndarray:
    """(N,) node->shard assignment, exactly N / n_shards nodes per shard:
    live nodes Z-order sorted by position and chunked, dead (padding) slots
    filling the trailing shards."""
    N = node_mask.shape[0]
    if N % n_shards != 0:
        raise ValueError(f"node capacity {N} must divide by the shard count {n_shards}")
    C = N // n_shards
    live = np.nonzero(node_mask)[0]
    dead = np.nonzero(~node_mask)[0]
    if len(live):
        p = np.asarray(positions[live, :2], np.float64)
        mn = p.min(axis=0)
        ext = max(float(np.ptp(p, axis=0).max()), 1e-6)
        q = np.clip(((p - mn) / ext * 1023.0).astype(np.int64), 0, 1023)
        live = live[np.argsort(morton_code(q[:, 0], q[:, 1]), kind="stable")]
    order = np.concatenate([live, dead])
    assign = np.zeros(N, np.int32)
    assign[order] = (np.arange(N) // C).astype(np.int32)
    return assign
