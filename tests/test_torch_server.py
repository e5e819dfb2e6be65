"""Port parity: dpg_slam_tpu_torch.batch.BatchedSlamServer (the online
mode) against the port's own offline batched run and the JAX package's
server, at tests/test_batch.py's server configuration (its small config
with 128 ICP points, two office sequences at 0.5 m steps, seeds 1 and 2,
odometry noise 0.003 m / 0.001 rad). The JAX server runs its plain ICP
(use_kernel=False), as the JAX package's own tests do.

Tolerances:
- immediate mode against process_sessions_batched at solve_stride 1 (same
  bucket and method): keyframe ticks, counts, every state leaf and the
  poses equal to the bit. A lane's result does not depend on which lanes
  share its steps, so nothing looser is needed;
- bounded delay: tests/test_batch.py's bars (batching happened, every lane
  at least 10 nodes, ATE < 0.3 m);
- against the JAX server after every tick: the host gate arrays, step and
  keyframe counters and wait histograms equal; at the end poses within
  test_torch_batch.POSE_TOL (2e-3 m / rad) and edge counts within 4 (the
  JAX server test's bound).
"""

import inspect

import numpy as np
import pytest
import torch

from dpg_slam_tpu import batch as jb
from dpg_slam_tpu.io import dataset
from dpg_slam_tpu.utils.metrics import ate_rmse, to_anchor_frame
from dpg_slam_tpu_torch import batch as tb
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.utils import checkpoint as tckpt

from test_batch import small_config
from test_torch_batch import POSE_TOL, _assert_poses_close

# Host arrays of the server (gate recurrence and pending buffers) that must
# match the JAX server's after every tick.
GATE_ARRAYS = ("_initialized", "_first", "_odom_at_last", "_prev_odom", "_cum",
               "_pend_odom", "_pend_scan", "_pend", "_pend_age", "_pend_cum")
POLICIES = {"immediate": dict(min_batch_fraction=1e-9), "bounded": dict(min_batch_fraction=1.0, max_wait_calls=4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's thousands of tiny CPU ops
    (as tests/test_torch_batch.py); restored for the worker's later
    modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server_sessions():
    """tests/test_batch.py::server_sessions, with the port's config."""
    jcfg = small_config(downsample_icp_points_ratio=2, icp_max_points=128)
    world = dataset.make_office_world()
    wps = dataset.office_loop_waypoints()
    seqs = [
        dataset.simulate_sequence(world, wps, jcfg.scan, step=0.5, seed=seed,
                                  odom_noise_transl=0.003, odom_noise_rot=0.001)
        for seed in (1, 2)
    ]
    return jcfg, TorchConfig.from_json(jcfg.to_json()), seqs


def _serve_lockstep(server_sessions, policy):
    """The port's and the JAX package's servers over the same ticks, the
    port's gate arrays compared with JAX's after every tick. Returns (port
    server, JAX server, per-lane keyframe ticks, ticks T, gate mismatches
    as (tick, array name))."""
    jcfg, tcfg, seqs = server_sessions
    T = min(len(s.scans) for s in seqs)
    kw = dict(POLICIES[policy], solve_bucket=jcfg.capacity.max_nodes)
    srv = tb.BatchedSlamServer(tcfg, n_sessions=2, device="cpu", **kw)
    jsrv = jb.BatchedSlamServer(jcfg, n_sessions=2, use_kernel=False, **kw)
    ticks, mismatches = [[], []], []
    for t in range(T):
        odom = np.stack([s.odometry[t] for s in seqs])
        scans = np.stack([s.scans[t] for s in seqs])
        newly = srv.observe(odom, scans)
        jnewly = jsrv.observe(odom, scans)
        if not np.array_equal(newly, jnewly):
            mismatches.append((t, "newly"))
        for name in GATE_ARRAYS:
            a, b = getattr(srv, name), getattr(jsrv, name)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                mismatches.append((t, name))
        for i in range(2):
            if newly[i]:
                ticks[i].append(t)
    srv.flush()
    jsrv.flush()
    return srv, jsrv, ticks, T, mismatches


@pytest.fixture(scope="module")
def immediate(server_sessions):
    return _serve_lockstep(server_sessions, "immediate")


@pytest.fixture(scope="module")
def bounded(server_sessions):
    return _serve_lockstep(server_sessions, "bounded")


def test_server_immediate_matches_offline(server_sessions, immediate):
    """Immediate mode against the port's offline run at stride 1 with the
    same bucket and method: the same keyframe ticks and, per lane, every
    state leaf equal to the bit."""
    _, tcfg, seqs = server_sessions
    srv, _, ticks, T, _ = immediate
    off, counts = tb.process_sessions_batched(
        tcfg, [(s.odometry[:T], s.scans[:T]) for s in seqs], solve_bucket=tcfg.capacity.max_nodes, device="cpu",
    )
    assert srv.method == "lanes_chol"
    for i, seq in enumerate(seqs):
        assert ticks[i] == list(np.nonzero(tb.keyframe_schedule(tcfg, seq.odometry[:T]))[0])
        assert srv.num_nodes(i) == counts[i] >= 10
        got = tckpt.state_to_numpy(tb.session_state(srv.states, i))
        want = tckpt.state_to_numpy(tb.session_state(off, i))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"lane {i}: {k}")
        np.testing.assert_array_equal(srv.trajectory(i), want["poses"][: counts[i]])


def test_server_bounded_delay_quality(server_sessions, bounded):
    """With real batching (all lanes pending, or 4 ticks), keyframes run
    on each lane's freshest gated scan and track as immediate execution
    does (tests/test_batch.py::test_server_bounded_delay_quality)."""
    _, _, seqs = server_sessions
    srv, _, _, T, _ = bounded
    assert srv.steps_executed < srv.keyframes_executed  # batching happened
    for i, seq in enumerate(seqs):
        n = srv.num_nodes(i)
        assert n >= 10
        odom_poses = srv.states.odom_poses[i, :n, :2].numpy()
        ticks = np.argmin(np.linalg.norm(seq.odometry[:T, None, :2] - odom_poses[None], axis=-1), axis=0)
        ate = ate_rmse(srv.trajectory(i), to_anchor_frame(seq.ground_truth[ticks]))
        assert ate < 0.3, f"lane {i} served ATE {ate}"


@pytest.mark.parametrize("policy", list(POLICIES))
def test_server_matches_jax_server(request, policy):
    """Against the JAX server on the same ticks: the host gate arrays equal
    after every tick, the same steps, keyframes and waits, and lanes within
    the batched mode's bounds."""
    srv, jsrv, _, _, mismatches = request.getfixturevalue(policy)
    assert mismatches == []
    assert (srv.steps_executed, srv.keyframes_executed) == (jsrv.steps_executed, jsrv.keyframes_executed)
    assert len(srv.wait_hist) == len(jsrv.wait_hist) == srv.steps_executed
    for a, b in zip(srv.wait_hist, jsrv.wait_hist):
        np.testing.assert_array_equal(a, b)
    for i in range(2):
        n = srv.num_nodes(i)
        assert n == jsrv.num_nodes(i)
        assert int(srv.states.graph.num_priors[i]) == int(jsrv.states.graph.num_priors[i])
        assert abs(int(srv.states.graph.num_edges[i]) - int(jsrv.states.graph.num_edges[i])) <= 4
        np.testing.assert_array_equal(srv.states.odom_poses[i, :n].numpy(), np.asarray(jsrv.states.odom_poses[i, :n]))
        _assert_poses_close(srv.trajectory(i), jsrv.trajectory(i), POSE_TOL)


@pytest.mark.parametrize("method", ["dense", "dense_cg"])
def test_server_refuses_vmapped_engine_solves(server_sessions, method):
    with pytest.raises(ValueError, match="does not carry"):
        tb.BatchedSlamServer(server_sessions[1], 2, solve_method=method, device="cpu")


def test_server_runs_on_the_card_by_default():
    params = inspect.signature(tb.BatchedSlamServer).parameters
    assert params["device"].default == "cuda"
    assert "use_kernel" not in params
    assert [p for p in params if p != "device"] == [
        p for p in inspect.signature(jb.BatchedSlamServer).parameters if p != "use_kernel"
    ]
