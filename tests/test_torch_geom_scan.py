"""Port parity: dpg_slam_tpu_torch.{config,geom,scan} against the JAX
package on the same numpy inputs.

Tolerance: atol 1e-6 — both sides evaluate the same float32 formulas;
only libm sin/cos and operation order can differ in the last ulp."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu import geom as jgeom
from dpg_slam_tpu import scan as jscan
from dpg_slam_tpu.config import DpgConfig as JaxConfig
from dpg_slam_tpu.config import ScanParams as JaxScanParams
from dpg_slam_tpu_torch import geom as tgeom
from dpg_slam_tpu_torch import scan as tscan
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.config import PoseGraphParams as TorchPG
from dpg_slam_tpu_torch.config import ScanParams as TorchScanParams

ATOL = 1e-6


def _poses(rng, shape):
    p = rng.uniform(-5, 5, shape + (3,)).astype(np.float32)
    p[..., 2] = rng.uniform(-7, 7, shape).astype(np.float32)  # beyond ±π: wrapping
    return p


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["compose", "between"])
def test_binary_pose_ops(name):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, (5, 4)), _poses(rng, (5, 4))
    got = getattr(tgeom, name)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jgeom, name)(jnp.asarray(a), jnp.asarray(b))
    _close(got, want)


def test_inverse_and_angles():
    rng = np.random.default_rng(1)
    a = _poses(rng, (64,))
    _close(tgeom.inverse(torch.from_numpy(a)), jgeom.inverse(jnp.asarray(a)))
    ang = np.concatenate(
        [rng.uniform(-20, 20, 64), np.array([np.pi, -np.pi, 3 * np.pi, 0.0])]
    ).astype(np.float32)
    ang2 = rng.uniform(-20, 20, ang.shape).astype(np.float32)
    t, j = torch.from_numpy(ang), jnp.asarray(ang)
    t2, j2 = torch.from_numpy(ang2), jnp.asarray(ang2)
    _close(tgeom.wrap_angle(t), jgeom.wrap_angle(j))
    _close(tgeom.angle_diff(t, t2), jgeom.angle_diff(j, j2))
    _close(tgeom.angle_dist(t, t2), jgeom.angle_dist(j, j2))


def test_wrap_angle_rounds_half_to_even():
    # x / 2π = ±0.5 exactly in float32: rint picks the even multiple (0).
    half = np.float32(np.float32(2 * np.pi) * np.float32(0.5))
    x = np.array([half, -half, 3 * half], np.float32)
    _close(tgeom.wrap_angle(torch.from_numpy(x)), jgeom.wrap_angle(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["apply", "inv_apply"])
@pytest.mark.parametrize("batched_points", [False, True])
def test_point_ops(name, batched_points):
    rng = np.random.default_rng(2)
    pose = _poses(rng, (3,))
    pts = rng.uniform(-4, 4, (3, 7, 2) if batched_points else (3, 2)).astype(np.float32)
    got = getattr(tgeom, name)(torch.from_numpy(pose), torch.from_numpy(pts))
    want = getattr(jgeom, name)(jnp.asarray(pose), jnp.asarray(pts))
    _close(got, want)


def test_inv_sym3():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(16, 3, 3))
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    H[0] = 0.0  # singular block -> zeros on both sides
    got = tgeom.inv_sym3(torch.from_numpy(H))
    want = jgeom.inv_sym3(jnp.asarray(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


def _scan_inputs(rng, params):
    r = rng.uniform(0.0, 12.0, (3, params.num_beams)).astype(np.float32)
    r[0, :5] = np.nan
    r[1, 5:9] = np.inf
    r[2, 9:12] = 0.01  # below range_min
    return r


def test_scan_functions():
    rng = np.random.default_rng(4)
    tp = TorchScanParams(num_beams=100)
    jp = JaxScanParams(num_beams=100)
    r = _scan_inputs(rng, tp)
    tr, jr = torch.from_numpy(r), jnp.asarray(r)

    tl, jl = tscan.initial_labels(tr, tp), jscan.initial_labels(jr, jp)
    assert tl.dtype == torch.int8
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tscan.valid_mask(tl).numpy(), np.asarray(jscan.valid_mask(jl)))
    np.testing.assert_array_equal(
        tscan.sector_ids(tp, 7, "cpu").numpy(), np.asarray(jscan.sector_ids(jp, 7))
    )

    finite = np.nan_to_num(r, nan=1.0, posinf=11.0)
    tf, jf = torch.from_numpy(finite), jnp.asarray(finite)
    _close(tscan.points_in_laser_frame(tf, tp), jscan.points_in_laser_frame(jf, jp), atol=1e-5)
    ext = np.array([0.2, -0.1, 0.3], np.float32)
    _close(
        tscan.points_in_base_link(tf, tp, torch.from_numpy(ext)),
        jscan.points_in_base_link(jf, jp, jnp.asarray(ext)),
        atol=1e-5,
    )


@pytest.mark.parametrize("max_points", [8, 40])  # truncating and padding
def test_downsample(max_points):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(2, 100, 2)).astype(np.float32)
    valid = rng.uniform(size=(2, 100)) > 0.3
    tp, tm = tscan.downsample(torch.from_numpy(pts), torch.from_numpy(valid), 3, max_points)
    jp, jm = jscan.downsample(jnp.asarray(pts), jnp.asarray(valid), 3, max_points)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_config_json_round_trips_between_packages():
    jcfg = JaxConfig()
    tcfg = TorchConfig.from_json(jcfg.to_json())
    assert tcfg.to_dict() == jcfg.to_dict()
    custom = TorchConfig(pose_graph=TorchPG(icp_max_points=64, robust_delta=None))
    assert JaxConfig.from_json(custom.to_json()).to_dict() == custom.to_dict()
    # Same field names and defaults, section by section.
    for section in ("scan", "pose_graph", "dpg", "viz", "capacity"):
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, section))]
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, section))]
        assert tf == jf, section


@pytest.mark.parametrize("fixture", ["keyframe", "session"])
def test_config_reads_committed_bench_assets(fixture):
    import pathlib

    text = (pathlib.Path(__file__).parent.parent / "bench_assets" / fixture / "config.json").read_text()
    assert TorchConfig.from_json(text).to_dict() == JaxConfig.from_json(text).to_dict()
