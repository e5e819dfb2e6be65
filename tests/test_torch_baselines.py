"""The port's copies of the serial baseline harness
(dpg_slam_tpu_torch/baselines/serial_cpu.py) and of the visualization
export (dpg_slam_tpu_torch/viz.py) against the JAX package's, on
tests/test_native_baseline.py's wall-cloud setup. Both are numpy (and
ctypes over native/build/libdpgslam_host.so), so results are equal to
the bit; the native harness's times are not compared."""

import math

import numpy as np
import pytest

from dpg_slam_tpu import viz as jviz
from dpg_slam_tpu.baselines import serial_cpu as jserial
from dpg_slam_tpu_torch import viz
from dpg_slam_tpu_torch.baselines import serial_cpu
from dpg_slam_tpu_torch.io.logs import native_lib
from test_native_baseline import _setup

ICP_PARAMS = dict(max_iters=30, gate=0.6, epsilon=5e-9)


def _continuation(n_steps=4, seed=1):
    rng = np.random.default_rng(seed)
    new_clouds = [np.stack([np.linspace(-2, 2, 40), np.full(40, 1.5 - 0.05 * k)], axis=1)
                  + rng.normal(0, 0.02, (40, 2)) for k in range(n_steps)]
    deltas = np.array([[0.4 + 0.02 * k, 0.01, 0.02] for k in range(n_steps)])
    return new_clouds, deltas


def _native_ready():
    lib = native_lib()
    if lib is None or not hasattr(lib, "baseline_bench"):
        pytest.skip("native library not built")


def test_icp_serial_equals_jax():
    clouds, _, _, _ = _setup()
    for i in range(1, len(clouds)):
        seed = np.array([0.05 * i, -0.02, 0.01])
        got = serial_cpu.icp_serial(clouds[i], clouds[i - 1], seed, **ICP_PARAMS)
        want = jserial.icp_serial(clouds[i], clouds[i - 1], seed, **ICP_PARAMS)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_solve_serial_equals_jax():
    _, poses, priors, edges = _setup()
    noisy = poses + np.random.default_rng(3).normal(0, 0.05, poses.shape)
    np.testing.assert_array_equal(serial_cpu.solve_serial(noisy, priors, edges, iters=10),
                                  jserial.solve_serial(noisy, priors, edges, iters=10))


def test_keyframe_steps_equal_jax():
    """tests/test_native_baseline.py's numpy keyframe loop on both packages."""
    clouds, poses, priors, edges = _setup()
    new_clouds, deltas = _continuation()
    W = np.diag([1 / 0.6] * 3)
    runs = []
    for mod in (serial_cpu, jserial):
        c, p, e = [x.astype(np.float64) for x in clouds], poses.copy(), list(edges)
        for k in range(len(new_clouds)):
            prev = p[-1]
            R = np.array([[np.cos(prev[2]), -np.sin(prev[2])], [np.sin(prev[2]), np.cos(prev[2])]])
            seed = np.array([*(prev[:2] + R @ deltas[k][:2]), prev[2] + deltas[k][2]])
            cands = np.argsort(np.linalg.norm(p[:-1, :2] - seed[:2], axis=1))[:3].tolist()
            e.append((len(p) - 1, len(p), deltas[k].copy(), W))
            p, e = mod.keyframe_step_serial(c, p, new_clouds[k], seed, priors, e, closure_candidates=cands,
                                            icp_params=ICP_PARAMS)
            c.append(new_clouds[k])
        runs.append((p, e))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert len(runs[0][1]) == len(runs[1][1])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])


def test_native_baseline_bench_equals_jax():
    _native_ready()
    clouds, poses, priors, edges = _setup()
    new_clouds, deltas = _continuation()
    W = np.diag([1 / 0.6] * 3)
    kw = dict(closures_k=3, icp_params=ICP_PARAMS, return_poses=True)
    fps, got = serial_cpu.native_baseline_bench(clouds, poses, list(edges), priors[0][2], new_clouds, deltas, W, **kw)
    _, want = jserial.native_baseline_bench(clouds, poses, list(edges), priors[0][2], new_clouds, deltas, W, **kw)
    assert fps is not None and fps > 0 and got.shape == (len(clouds) + len(new_clouds), 3)
    np.testing.assert_array_equal(got, want)


def test_native_baseline_reoptimize_equals_jax():
    _native_ready()
    clouds, poses, priors, _ = _setup()
    odom = poses + np.random.default_rng(5).normal(0, 0.03, poses.shape)
    pass_ids = np.repeat([0, 1], len(poses) // 2)
    args = (clouds, poses, odom, pass_ids, priors[0][2], np.diag([1 / 0.6] * 3))
    kw = dict(radius_within=5.0, radius_cross=2.0, min_gap=2, closures_k=3, icp_params=ICP_PARAMS, gn_iters=10,
              return_poses=True)
    secs, pairs, got = serial_cpu.native_baseline_reoptimize(*args, **kw)
    _, want_pairs, want = jserial.native_baseline_reoptimize(*args, **kw)
    assert secs >= 0 and pairs == want_pairs > len(poses) - 1
    np.testing.assert_array_equal(got, want)


# --- viz -----------------------------------------------------------------------

def _draw(mod):
    c = mod.Canvas(frame="odom")
    c.draw_point((1.0, 2.0), mod.Color4f.BLUE)
    c.draw_points(np.array([[0.0, 0.0], [1.0, 1.0]]), mod.Color4f.from_hex("#2ca02c"))
    c.draw_line((0, 0), (1, 0))
    c.draw_cross((5, 5), 0.5)
    c.draw_arc((0, 0), 2.0, 0.0, math.pi)
    c.draw_particle((3, 3), math.pi / 2)
    c.draw_path_option(0.0, 2.0, 0.5)
    c.draw_path_option(0.5, 2.0, 0.3)
    c.draw_path_option(-0.4, 1.5, 0.0)
    c.draw_text((1, 1), "x")
    return c.to_dict()


def test_canvas_serialization_equals_jax():
    got, want = _draw(viz), _draw(jviz)
    assert got["frame"] == want["frame"] == "odom"
    for k in ("points", "lines", "arcs"):
        assert got[k].shape[0] > 0
        np.testing.assert_array_equal(got[k], want[k])
    for c in (viz.Color4f(0.2, 0.4, 0.6, 0.5), viz.Color4f.RED, viz.Color4f.from_hex("#98df8a80")):
        assert c.to_hex() == jviz.Color4f(c.r, c.g, c.b, c.a).to_hex()


def test_trajectory_ticks_equal_jax():
    poses = np.random.default_rng(4).normal(0, 2.0, (25, 3))
    np.testing.assert_array_equal(viz.trajectory_ticks(poses), jviz.trajectory_ticks(poses))
    np.testing.assert_array_equal(viz.trajectory_ticks(poses, 0.5), jviz.trajectory_ticks(poses, 0.5))
