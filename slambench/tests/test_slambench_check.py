"""The check that decides `correct`: a sound run passes it, the control
(the reference computed in TF32 in the program's place) fails it, and a
run with the timed path broken underneath fails it, at a small size on
the CPU (where the program runs its plain ICP instead of K1)."""

import pytest
import torch

from dpg_slam_tpu_torch import batch, engine
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.ops import icp
from slambench import check, run
from slambench.tests import tiny


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    return {c: tiny.spec(d, c) for c in tiny.CELLS}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_passes_and_control_fails(specs, cell):
    c = run.Cell(specs[cell], 21, "cpu")
    final, _, nodes, items = c.captured_job()
    ok, table = check.judge(c.numbers(items, [nodes], final), specs[cell]["limits"])
    assert ok, table
    ok, table = check.judge(c.control_numbers(items), specs[cell]["limits"])
    assert not ok, table


def _keyframe_unchanged(fn):
    return lambda cfg, states, *a, **k: states


def _half_batch(fn):
    def call(cfg, states, odom, ranges, valid):
        return fn(cfg, states, odom, ranges, valid & (torch.arange(valid.shape[0]) < valid.shape[0] // 2))
    return call


def _answer_altered(fn):
    def call(*a, **k):
        out = fn(*a, **k)
        t = out.transform.clone()
        t[0, 0] += 0.05
        return out._replace(transform=t)
    return call


def _closures_dropped(fn):
    return lambda *a, **k: torch.zeros_like(fn(*a, **k))


def _covariance_altered(fn):
    return lambda cov: 1.5 * fn(cov)


def _solve_unchanged(fn):
    return lambda poses, g, node_mask, **k: (poses.clone(), None)


def _third_of_lanes_unsolved(fn):
    def call(poses, g, node_mask, **k):
        out, info = fn(poses, g, node_mask, **k)
        out = out.clone()
        n = max(1, poses.shape[0] // 3)
        out[:n] = poses[:n]
        return out, info
    return call


def _boundary_unchanged(fn):
    def call(cfg, states, *a, **k):
        out = fn(cfg, states, *a, **k)
        return out._replace(poses=states.poses.clone())
    return call


def _boundary_lane_unchanged(fn):
    def call(cfg, states, *a, **k):
        out = fn(cfg, states, *a, **k)
        poses = out.poses.clone()
        poses[-1] = states.poses[-1]
        return out._replace(poses=poses)
    return call


FAULTS = {
    "keyframe_step_unchanged": (batch, "_lanes_keyframe", _keyframe_unchanged),
    "half_the_lanes_left_out": (batch, "_lanes_keyframe", _half_batch),
    "registration_altered": (icp, "icp_align", _answer_altered),
    "closures_dropped": (engine, "_closure_consistency_votes", _closures_dropped),
    "covariance_altered": (fg, "sqrt_info_from_covariance", _covariance_altered),
    "solve_unchanged": (fg, "solve_batched", _solve_unchanged),
    "third_of_lanes_unsolved": (fg, "solve_batched", _third_of_lanes_unsolved),
    "boundary_unchanged": (batch, "batched_increment_pass", _boundary_unchanged),
    "boundary_lane_unchanged": (batch, "batched_increment_pass", _boundary_lane_unchanged),
}
CASES = [(c, f) for c in tiny.CELLS for f in FAULTS if not (f.startswith("boundary") and c.startswith("fleet"))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(specs, monkeypatch, cell, fault):
    module, attr, make = FAULTS[fault]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    out = run.run_cell(specs[cell], 23, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]
    assert out["failed"] == 1
