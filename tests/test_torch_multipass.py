"""Port parity: dpg_slam_tpu_torch.batch.process_sessions_multipass (the
batched multipass mode: the keyframe loop of every pass, the lanes' DPG
step after each keyframe of pass 1, batched_increment_pass between
passes) on tests/test_batch.py::multipass_setup's scenario (two lanes of
the two-pass box scene at _dpg_small_config, seeds 3/4 and 13/14). The
JAX package runs its plain ICP (use_kernel=False), as its own tests do.

Tolerances: against the port's two-pass engine per lane,
test_multipass_batched_matches_engine's bars (node counts equal,
trajectory within 0.05 m, ADDED and REMOVED found and within 2x of the
engine's); against JAX's process_sessions_multipass, keyframe counts
equal, poses within 2e-3 m / rad (tests/test_torch_batch.py's lane bound),
and the label entries that differ and the ADDED and REMOVED counts each
within 3 % of JAX's changed points (tests/test_torch_dpg.py's engine
bound: the poses' ~1e-4 m drift moves a few points across a gate). The
counts are printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpg_slam_tpu import batch as jb
from dpg_slam_tpu_torch import batch as tb
from dpg_slam_tpu_torch import scan
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.engine import DpgSlamEngine

from test_batch import multipass_setup  # noqa: F401  (the scenario fixture)

POSE_TOL = 2e-3
ENGINE_TRAJ_TOL = 0.05
JAX_COUNT_FRAC = 0.03


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many tiny CPU ops (see
    tests/test_torch_batch.py); restored for the worker's later modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tcfg(multipass_setup):  # noqa: F811
    return TorchConfig.from_json(multipass_setup[0].to_json())


@pytest.fixture(scope="module")
def port_run(multipass_setup, tcfg):  # noqa: F811
    return tb.process_sessions_multipass(tcfg, multipass_setup[1], device="cpu")


def _changes(labels):
    labels = np.asarray(labels)
    return int((labels == scan.ADDED).sum()), int((labels == scan.REMOVED).sum())


def _lane(states, i):
    lane = tb.session_state(states, i)
    n = int(lane.num_nodes)
    return n, lane.poses[:n].numpy(), lane.labels[:n].numpy()


def _assert_poses_close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=atol)
    np.testing.assert_allclose(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))), 0.0, atol=atol)


def _assert_engine_class(name, n, poses, labels, ref_n, ref_poses, ref_labels):
    """test_multipass_batched_matches_engine's bars."""
    assert n == ref_n, f"{name}: node count {n} vs {ref_n}"
    d = np.abs(poses - ref_poses)[:, :2].max()
    assert d < ENGINE_TRAJ_TOL, f"{name}: trajectory {d}"
    for got, ref, kind in zip(_changes(labels), _changes(ref_labels), ("added", "removed")):
        assert got > 0, f"{name}: no {kind} points"
        assert ref / 2 <= got <= ref * 2, f"{name} {kind}: {got} vs {ref}"


def test_multipass_matches_engine(multipass_setup, tcfg, port_run):  # noqa: F811
    """Each lane against the port's engine over the same two passes
    (process_sequence, increment_pass, process_sequence with DPG)."""
    states, counts = port_run
    for i, ((o1, s1), (o2, s2)) in enumerate(multipass_setup[1]):
        eng = DpgSlamEngine(tcfg, "cpu")
        eng.process_sequence(o1, s1)
        eng.increment_pass()
        eng.process_sequence(o2, s2)
        n, poses, labels = _lane(states, i)
        assert sum(counts[i]) == n
        print(f"lane {i}: {counts[i]} keyframes; ADDED, REMOVED {_changes(labels)}, "
              f"engine {_changes(eng.state.labels[:n].numpy())}")
        _assert_engine_class(f"lane {i}", n, poses, labels, eng.num_nodes(), eng.trajectory(),
                             eng.state.labels[: eng.num_nodes()].numpy())
        lane = tb.session_state(states, i)
        assert int(lane.pass_number) == 1
        assert int(lane.sector_active[:n].sum()) <= int(lane.node_active[:n].sum()) * lane.sector_active.shape[-1]


def test_multipass_matches_jax(multipass_setup, port_run):  # noqa: F811
    jcfg, lanes = multipass_setup
    js, jcounts = jb.process_sessions_multipass(jcfg, lanes, use_kernel=False)
    states, counts = port_run
    assert counts == jcounts
    for i in range(len(lanes)):
        jl = jb.session_state(js, i)
        n, poses, labels = _lane(states, i)
        assert n == int(jl.num_nodes)
        assert int(tb.session_state(states, i).graph.num_edges) == int(jl.graph.num_edges)
        _assert_poses_close(poses, np.asarray(jl.poses[:n]), POSE_TOL)
        got, want = _changes(labels), _changes(jl.labels[:n])
        jlabels = np.asarray(jl.labels[:n])
        changed = (jlabels == scan.ADDED) | (jlabels == scan.REMOVED) | (labels == scan.ADDED) | (labels == scan.REMOVED)
        label_diff = int(((labels != jlabels) & changed).sum())
        print(f"lane {i}: ADDED, REMOVED port {got}, JAX {want}; label entries differ {label_diff}")
        bound = JAX_COUNT_FRAC * sum(want)
        assert min(want) > 0 and label_diff <= bound, (got, want, label_diff)
        assert all(abs(g - w) <= bound for g, w in zip(got, want)), (got, want)


def test_multipass_stride_orders(multipass_setup, tcfg, port_run):  # noqa: F811
    """solve_stride 2 (keyframe, DPG for each keyframe of the group, then
    the solve) against stride 1 (keyframe, solve, DPG) on the same lanes:
    the same keyframes, and the engine's bars between the two."""
    states, counts = port_run
    strided, s_counts = tb.process_sessions_multipass(tcfg, multipass_setup[1], solve_stride=2, device="cpu")
    assert s_counts == counts
    for i in range(len(counts)):
        n, poses, labels = _lane(strided, i)
        print(f"lane {i}: ADDED, REMOVED stride 2 {_changes(labels)}, stride 1 {_changes(_lane(states, i)[2])}")
        _assert_engine_class(f"lane {i} stride 2", n, poses, labels, *_lane(states, i))


def test_multipass_capacity_check(multipass_setup, tcfg):  # noqa: F811
    tight = tcfg.replace(capacity=dataclasses.replace(tcfg.capacity, max_nodes=48))
    with pytest.raises(ValueError, match="cumulative keyframes exceed"):
        tb.process_sessions_multipass(tight, multipass_setup[1], device="cpu")


def test_multipass_needs_equal_pass_counts(multipass_setup, tcfg):  # noqa: F811
    lanes = multipass_setup[1]
    with pytest.raises(ValueError, match="same pass count"):
        tb.process_sessions_multipass(tcfg, [lanes[0], lanes[1][:1]], device="cpu")


def test_multipass_entry_point_requires_a_device():
    import inspect

    for fn in (tb.process_sessions_multipass,):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
