"""The plain reference the benchmark holds the program's results against:
plain PyTorch written for this benchmark, float32 with TF32 off, with no
kernel, batching trick or state of the program. It reads the
configuration from the cell's JSON file and its inputs from the
benchmark; it imports nothing of the program.

The control of the check is this reference with every float input and
the operands of its products rounded to TF32 (``geom.tf32``): the
precision below the configuration's float32 that a tensor-core path would
bring."""

from __future__ import annotations

import copy
from types import SimpleNamespace


class _Scan(SimpleNamespace):
    @property
    def angle_increment(self) -> float:
        return (self.angle_max - self.angle_min) / (self.num_beams - 1.0)


def config(tree: dict) -> SimpleNamespace:
    """The configuration tree of a cell's JSON file as attributes
    (cfg.scan.num_beams, cfg.pose_graph.icp_max_points, ...)."""
    groups = {k: SimpleNamespace(**v) for k, v in tree.items() if k != "scan"}
    return SimpleNamespace(scan=_Scan(**tree["scan"]), **groups)


def with_fields(ns: SimpleNamespace, **kw) -> SimpleNamespace:
    out = copy.copy(ns)
    for k, v in kw.items():
        setattr(out, k, v)
    return out
