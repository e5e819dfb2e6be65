"""Port parity: dpg_slam_tpu_torch.batch (the session-batched mode) and
graph.factor_graph.solve_batched against the JAX package, at
tests/test_batch.py's small configuration (256 beams, 64 ICP points,
K = 4, 64 nodes, 512 edges; sessions of seeds 1 and 2 at 0.5 m steps).
The JAX package runs its plain ICP (use_kernel=False), as its own tests do.

Tolerances: keyframe schedules, counts and edge lists exact; lane poses
within 2e-3 m / rad of JAX's lanes and of the port's own sequential
process_sequence (tests/test_batch.py's bound between batched and
sequential runs); solve_batched on identical stacked graphs within 1e-4
("chol": two float32 Cholesky orders through five LM steps) and 1e-4
("cg_fixed": twelve PCG iterations a step), with the same accepted-step
counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpg_slam_tpu import batch as jb
from dpg_slam_tpu.graph import factor_graph as jfg
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu.utils.metrics import ate_rmse, to_anchor_frame
from dpg_slam_tpu_torch import batch as tb
from dpg_slam_tpu_torch import engine as teng
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.graph import factor_graph as tfg
from dpg_slam_tpu_torch.utils import checkpoint as tckpt
from dpg_slam_tpu_torch.utils import profiling

from test_batch import _make_session, small_config

POSE_TOL = 2e-3
SOLVE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops: one intra-op
    thread avoids the OpenMP overhead that dominates them when the test
    workers share the cores. Restored for the worker's later modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(seqs):
    return [(s.odometry, s.scans) for s in seqs]


@pytest.fixture(scope="module")
def cfgs():
    jcfg = small_config()
    return jcfg, TorchConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def seqs(cfgs):
    return [_make_session(cfgs[0], seed) for seed in (1, 2)]


@pytest.fixture(scope="module")
def jax_lanes(cfgs, seqs):
    return jb.process_sessions_batched(cfgs[0], _streams(seqs), use_kernel=False)


@pytest.fixture(scope="module")
def port_lanes(cfgs, seqs):
    return tb.process_sessions_batched(cfgs[1], _streams(seqs), device="cpu")


def _assert_poses_close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=atol)
    np.testing.assert_allclose(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))), 0.0, atol=atol)


def _lane_numpy(states, i):
    return tckpt.state_to_numpy(tb.session_state(states, i))


def test_schedule_and_packing_match_jax(cfgs, seqs):
    jcfg, tcfg = cfgs
    for seq in seqs:
        np.testing.assert_array_equal(tb.keyframe_schedule(tcfg, seq.odometry), jb.keyframe_schedule(jcfg, seq.odometry))
    short = [(seqs[0].odometry[:40], seqs[0].scans[:40]), _streams(seqs)[1]]
    for got, want in zip(tb.pack_sessions(tcfg, short), jb.pack_sessions(jcfg, short)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pack_sessions_warns_at_the_edge_budget(cfgs, seqs):
    _, tcfg = cfgs
    tight = tcfg.replace(capacity=dataclasses.replace(tcfg.capacity, max_edges=60))
    with pytest.warns(UserWarning, match="edge budget"):
        _, _, _, counts = tb.pack_sessions(tight, _streams(seqs)[:1])
    assert counts == [60 // 6]


def test_batched_lanes_match_jax(jax_lanes, port_lanes):
    js, jcounts = jax_lanes
    ts, tcounts = port_lanes
    assert tcounts == jcounts
    for i in range(len(tcounts)):
        jl, tl = jb.session_state(js, i), tb.session_state(ts, i)
        n = int(jl.num_nodes)
        assert int(tl.num_nodes) == n == tcounts[i]
        assert int(tl.graph.num_priors) == int(jl.graph.num_priors)
        ne = int(jl.graph.num_edges)
        assert int(tl.graph.num_edges) == ne
        np.testing.assert_array_equal(tl.graph.edge_idx[:ne].numpy(), np.asarray(jl.graph.edge_idx[:ne]))
        _assert_poses_close(tl.poses[:n].numpy(), np.asarray(jl.poses[:n]), POSE_TOL)


def test_batched_lanes_match_process_sequence(cfgs, seqs, port_lanes):
    """Each lane against the port's own offline run of its session."""
    _, tcfg = cfgs
    ts, counts = port_lanes
    for i, seq in enumerate(seqs):
        eng = teng.DpgSlamEngine(tcfg, "cpu")
        eng._dpg_enabled = False
        kf = eng.process_sequence(seq.odometry, seq.scans)
        lane = tb.session_state(ts, i)
        assert int(kf.sum()) == counts[i] == int(lane.num_nodes) == eng.num_nodes()
        assert int(lane.graph.num_edges) == int(eng.state.graph.num_edges)
        assert int(lane.graph.num_priors) == int(eng.state.graph.num_priors)
        _assert_poses_close(lane.poses[: counts[i]].numpy(), eng.trajectory(), POSE_TOL)


def test_batched_padding_lanes(cfgs, seqs):
    """A short session padded to a long one matches its solo run."""
    _, tcfg = cfgs
    half = len(seqs[0].scans) // 2
    short = (seqs[0].odometry[:half], seqs[0].scans[:half])
    solo, solo_counts = tb.process_sessions_batched(tcfg, [short], device="cpu")
    mixed, mixed_counts = tb.process_sessions_batched(tcfg, [short, _streams(seqs)[1]], device="cpu")
    assert mixed_counts[0] == solo_counts[0] < mixed_counts[1]
    n = solo_counts[0]
    lane, alone = tb.session_state(mixed, 0), tb.session_state(solo, 0)
    assert int(lane.num_nodes) == int(alone.num_nodes) == n
    assert int(lane.graph.num_edges) == int(alone.graph.num_edges)
    _assert_poses_close(lane.poses[:n].numpy(), alone.poses[:n].numpy(), POSE_TOL)


def test_batched_lanes_track_accurately(cfgs, seqs, port_lanes):
    _, tcfg = cfgs
    ts, counts = port_lanes
    for i, seq in enumerate(seqs):
        kf_idx = np.nonzero(tb.keyframe_schedule(tcfg, seq.odometry))[0][: counts[i]]
        ate = ate_rmse(tb.session_state(ts, i).poses[: counts[i]].numpy(), to_anchor_frame(seq.ground_truth[kf_idx]))
        assert ate < 0.25, f"lane {i} ATE {ate}"


def test_batched_solve_stride_accuracy(cfgs, seqs, port_lanes):
    _, tcfg = cfgs
    base, counts = port_lanes
    strided, stride_counts = tb.process_sessions_batched(tcfg, _streams(seqs), solve_stride=4, device="cpu")
    assert stride_counts == counts
    for i, seq in enumerate(seqs):
        n = counts[i]
        assert int(tb.session_state(strided, i).num_nodes) == n
        gt = to_anchor_frame(seq.ground_truth[np.nonzero(tb.keyframe_schedule(tcfg, seq.odometry))[0][:n]])
        ate_base = ate_rmse(tb.session_state(base, i).poses[:n].numpy(), gt)
        ate_stride = ate_rmse(tb.session_state(strided, i).poses[:n].numpy(), gt)
        assert ate_stride < 0.25, f"lane {i} stride-4 ATE {ate_stride}"
        assert ate_stride < ate_base * 1.5 + 0.05, (ate_stride, ate_base)


@pytest.mark.parametrize("method", ["chol", "cg_fixed"])
def test_solve_batched_matches_jax(cfgs, jax_lanes, method):
    """Both packages' solve_batched on the same stacked graphs (JAX's
    batched lanes carried over with state_from_numpy(lanes=...)), from
    seeded perturbations of the solved poses."""
    import jax.numpy as jnp

    jcfg, tcfg = cfgs
    js, counts = jax_lanes
    S = len(counts)
    ts = tckpt.state_from_numpy(_flatten_state(js), tcfg, "cpu", lanes=S)
    rng = np.random.default_rng(5)
    init = np.asarray(js.poses) + rng.normal(0, [0.05, 0.05, 0.02], js.poses.shape).astype(np.float32)
    mask = np.arange(init.shape[1])[None, :] < np.asarray(counts)[:, None]
    init[~mask] = 0.0
    pg = jcfg.pose_graph
    kw = dict(max_iterations=5, damping_init=pg.gn_damping_init, method=method, cg_iterations=12,
              robust_delta=pg.robust_delta, gradient_tol=pg.gn_gradient_tol, terminate_on_reject=True, rel_tol=1e-4)
    jp, jstats = jfg.solve_batched(jnp.asarray(init), js.graph, jnp.asarray(mask), **kw)
    tp, tstats = tfg.solve_batched(torch.from_numpy(init), ts.graph, torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(tstats.iterations.numpy(), np.asarray(jstats.iterations))
    assert (tstats.iterations > 0).all()
    for s in range(S):
        n = counts[s]
        _assert_poses_close(tp[s, :n].numpy(), np.asarray(jp[s, :n]), SOLVE_TOL)
    np.testing.assert_allclose(tstats.final_error.numpy(), np.asarray(jstats.final_error), rtol=1e-4)


def test_batched_increment_pass_matches_jax_and_engine(cfgs, jax_lanes):
    """Every lane's pass boundary on JAX's stacked lanes (carried over with
    state_from_numpy(lanes=...)): against JAX's batched_increment_pass,
    poses within 2e-3 (tests/test_torch_engine.py's reoptimize bound) and
    the same edges and pass bookkeeping; against the port's own engine
    reoptimize of each lane, poses within 1e-6 (the target is equality)."""
    jcfg, tcfg = cfgs
    js, counts = jax_lanes
    S = len(counts)
    ts = tckpt.state_from_numpy(_flatten_state(js), tcfg, "cpu", lanes=S)
    jout = jb.batched_increment_pass(jcfg, js, use_kernel=False)
    tout = tb.batched_increment_pass(tcfg, ts)
    for i, n in enumerate(counts):
        jl, tl = jb.session_state(jout, i), tb.session_state(tout, i)
        ne = int(jl.graph.num_edges)
        assert int(tl.graph.num_edges) == ne and int(tl.graph.num_priors) == int(jl.graph.num_priors)
        np.testing.assert_array_equal(tl.graph.edge_idx[:ne].numpy(), np.asarray(jl.graph.edge_idx[:ne]))
        _assert_poses_close(tl.poses[:n].numpy(), np.asarray(jl.poses[:n]), POSE_TOL)
        for k in ("pass_number", "first_scan_for_pass", "odom_initialized", "cumulative_dist"):
            assert getattr(tl, k).item() == np.asarray(getattr(jl, k)).item(), k

        eng = teng.DpgSlamEngine(tcfg, "cpu")
        eng.state = tb.session_state(ts, i)
        eng.increment_pass()
        one = eng.state
        diff = float((tl.poses[:n] - one.poses[:n]).abs().max())
        print(f"lane {i}: {n} nodes, {ne} edges; poses against the engine's reoptimize differ by {diff}")
        assert diff <= 1e-6
        assert int(one.graph.num_edges) == ne
        np.testing.assert_array_equal(tl.graph.edge_idx.numpy(), one.graph.edge_idx.numpy())
        for k in ("pass_number", "first_scan_for_pass", "odom_initialized", "cumulative_dist"):
            assert torch.equal(getattr(tl, k), getattr(one, k)), k


def test_padding_lane_is_untouched_by_a_step(cfgs, seqs, port_lanes):
    """A step with one lane padding leaves that lane's node rows, graph
    and scalars as they were, and writes the other lane's keyframe."""
    _, tcfg = cfgs
    states = tb._tree_map(torch.clone, port_lanes[0])
    before = _lane_numpy(states, 1)
    grown = _lane_numpy(states, 0)
    seq = seqs[0]
    t = len(seq.scans) - 1
    odom = torch.tensor(np.stack([seq.odometry[t], seq.odometry[t]]))
    scans = torch.tensor(np.stack([seq.scans[t], seq.scans[t]]))
    valid = torch.tensor([True, False])
    states = tb._process_sessions_batched(tcfg, states, odom[None], scans[None], valid[None], "lanes_chol", 64)
    after = _lane_numpy(states, 1)
    assert after.keys() == before.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    lane0 = _lane_numpy(states, 0)
    assert lane0["num_nodes"] == grown["num_nodes"] + 1
    assert lane0["graph/num_edges"] > grown["graph/num_edges"]


@pytest.mark.parametrize("method", ["dense", "dense_cg"])
def test_vmapped_engine_solves_are_not_carried(cfgs, seqs, method):
    with pytest.raises(ValueError, match="does not carry"):
        tb.process_sessions_batched(cfgs[1], _streams(seqs)[:1], solve_method=method, device="cpu")


def test_batched_cg_solve_runs_lane_by_lane(cfgs, seqs, port_lanes):
    """solve_method="cg" (the engine's block-sparse solve per lane) tracks
    as the lanes solve does."""
    _, tcfg = cfgs
    half = len(seqs[0].scans) // 2
    sessions = [(s.odometry[:half], s.scans[:half]) for s in seqs]
    lanes, counts = tb.process_sessions_batched(tcfg, sessions, device="cpu")
    cg, cg_counts = tb.process_sessions_batched(tcfg, sessions, solve_method="cg", device="cpu")
    assert cg_counts == counts
    for i, n in enumerate(counts):
        _assert_poses_close(tb.session_state(cg, i).poses[:n].numpy(), tb.session_state(lanes, i).poses[:n].numpy(), 0.05)


def test_batched_entry_point_requires_a_device():
    import inspect

    for fn in (tb.process_sessions_batched, tb._stack_states):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


GRAPH_COUNTERS = ("batch.keyframe_graph_captures", "batch.keyframe_graph_replays")


@pytest.mark.parametrize("call", ["loop", "single_step"])
def test_keyframe_graphs_stay_off_on_the_cpu_and_for_a_single_step(cfgs, seqs, call):
    """The keyframe loop captures its step as CUDA graphs only on a CUDA
    device: a CPU loop of more than the break-even step count, and a
    single _batched_keyframe_step (the server's), run eagerly and leave
    both graph counters as they were; both counters are in COUNTERS."""
    _, tcfg = cfgs
    assert set(GRAPH_COUNTERS) <= set(profiling.COUNTERS)
    sessions = [(s.odometry[:40], s.scans[:40]) for s in seqs]
    steps, counts, bucket, method = tb._schedule(tcfg, sessions, None, None, 2)
    steps = [torch.as_tensor(x) for x in steps]
    states = tb._stack_states(tcfg, len(sessions), "cpu")
    assert steps[0].shape[0] >= tb._GRAPH_MIN_STEPS
    before = profiling.counters()
    if call == "loop":
        assert tb._KeyframeGraphs.engage(states, steps[0].shape[0]) is None
        out = tb._process_sessions_batched(tcfg, states, *steps, method, bucket, 2)
        assert out.num_nodes.tolist() == counts
    else:
        out = tb._batched_keyframe_step(tcfg, states, steps[0][0], steps[1][0], steps[2][0], method, bucket)
        assert out.num_nodes.tolist() == [1, 1] and states.num_nodes.tolist() == [0, 0]
    after = profiling.counters()
    for name in GRAPH_COUNTERS:
        assert after.get(name, 0) == before.get(name, 0) == 0, name
    assert tb._LOOP_GRAPHS.get() is None
