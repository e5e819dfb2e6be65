"""The LM solve on a lane axis: graph.factor_graph.solve_lanes against the
port's own fg.solve on each lane, and batched_increment_pass (which solves
every lane's reoptimize graph in one solve_lanes call) against the JAX
package's batched_increment_pass (a jax.vmap of its reoptimize, LM
while_loop included) and the port's engine reoptimize per lane.

Tolerances: solve_lanes equals fg.solve to the bit (poses, final error,
accepted steps) for all four methods: a lane's arithmetic is the one-lane
solve's, op for op, in the same order ("dense" factors each live lane
alone, "dense_pallas"'s plain version solves each system alone, and
"dense_cg" runs its dense matvec one lane at a time; JAX's vmap freezes a
stopped lane, and so does solve_lanes). batched_increment_pass: against
JAX's, poses within 2e-3 m / rad (tests/test_torch_batch.py's bound) and
the same edges; against the port's engine, equal to the bit.
"""

import numpy as np
import pytest
import torch

from dpg_slam_tpu import batch as jb
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu_torch import batch as tb
from dpg_slam_tpu_torch import engine as teng
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.graph import factor_graph as tfg
from dpg_slam_tpu_torch.utils import checkpoint as tckpt

from test_batch import _make_session, small_config
from test_torch_factor_graph import _build, _random_graph

METHODS = ["dense", "dense_pallas", "dense_cg", "cg"]
POSE_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny CPU ops: one intra-op thread (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lane(seed: int, warm: int = 0, empty: bool = False):
    """(poses, graph, node_mask) of test_torch_factor_graph's random graph
    `seed`; `warm` LM steps already taken from its noisy start (the lane
    stops sooner), or with no factors at all (a zero gradient: done before
    the first iteration)."""
    spec = _random_graph(seed)
    g = _build(spec, tfg, torch.from_numpy)
    poses = torch.from_numpy(spec["init"])
    mask = torch.arange(poses.shape[0]) < spec["n_nodes"]
    if warm:
        poses, _ = tfg.solve(poses, g, mask, max_iterations=warm)
    if empty:
        g = tfg.empty_graph(g.prior_idx.shape[0], g.edge_idx.shape[0], "cpu")
    return poses, g, mask


@pytest.fixture(scope="module")
def lanes():
    return [_lane(0), _lane(3, warm=3), _lane(5, empty=True)]


def _stack(lanes):
    poses = torch.stack([p for p, _, _ in lanes])
    graph = tfg.FactorGraph(*(torch.stack(x) for x in zip(*(g for _, g, _ in lanes))))
    return poses, graph, torch.stack([m for _, _, m in lanes])


SETTINGS = {
    "plain": dict(),
    "robust": dict(robust_delta=2.0),
    "terminate_on_reject": dict(terminate_on_reject=True, rel_tol=1e-4),
    "gradient_tol": dict(gradient_tol=0.5, robust_delta=2.0),
    "few_iterations": dict(max_iterations=3),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("method", METHODS)
def test_solve_lanes_equals_solve_per_lane(lanes, method, setting):
    kw = dict(method=method, cg_iterations=16 if method == "cg" else 64, **SETTINGS[setting])
    poses, stats = tfg.solve_lanes(*_stack(lanes), **kw)
    accepted = []
    for s, (p, g, m) in enumerate(lanes):
        want, wstats = tfg.solve(p, g, m, **kw)
        assert torch.equal(poses[s], want), (s, float((poses[s] - want).abs().max()))
        assert torch.equal(stats.final_error[s], wstats.final_error)
        assert torch.equal(stats.initial_error[s], wstats.initial_error)
        assert int(stats.iterations[s]) == wstats.iterations
        accepted.append(wstats.iterations)
    # The lanes stop at different iterations; the empty lane never starts.
    assert accepted[2] == 0 and torch.equal(poses[2], lanes[2][0])
    if setting != "few_iterations":
        assert accepted[0] != accepted[1], accepted


def test_gradient_tol_freezes_a_converged_lane(lanes):
    """With gradient_tol above a lane's starting gradient that lane is done
    before the first iteration: poses and error as given."""
    p, g, m = lanes[1]
    eq, _ = tfg._assemble(p, g, m)
    tol = float(eq.rhs.abs().max()) * 1.5
    poses, stats = tfg.solve_lanes(*_stack(lanes[:2]), gradient_tol=tol)
    assert torch.equal(poses[1], p) and int(stats.iterations[1]) == 0
    assert torch.equal(stats.final_error[1], stats.initial_error[1])
    assert int(stats.iterations[0]) > 0


def test_solve_lanes_rejects_unknown_method(lanes):
    with pytest.raises(ValueError, match="unknown solve method"):
        tfg.solve_lanes(*_stack(lanes), method="chol")


@pytest.fixture(scope="module")
def jax_lanes():
    jcfg = small_config()
    seqs = [_make_session(jcfg, seed) for seed in (1, 2)]
    js, counts = jb.process_sessions_batched(jcfg, [(s.odometry, s.scans) for s in seqs], use_kernel=False)
    return jcfg, TorchConfig.from_json(jcfg.to_json()), js, counts


def _assert_poses_close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=atol)
    np.testing.assert_allclose(np.angle(np.exp(1j * (a[:, 2] - b[:, 2]))), 0.0, atol=atol)


def _assert_lanes_equal_engine(tcfg, ts, tout, method):
    """Each lane of batched_increment_pass's output equals the port's
    engine reoptimize of that lane, poses and graph, to the bit."""
    for i in range(ts.poses.shape[0]):
        eng = teng.DpgSlamEngine(tcfg, "cpu")
        eng.solve_method = method
        eng.state = tb.session_state(ts, i)
        eng.increment_pass()
        tl = tb.session_state(tout, i)
        assert torch.equal(tl.poses, eng.state.poses)
        for a, b in zip(tl.graph, eng.state.graph):
            assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["dense_cg", "cg"])
def test_batched_increment_pass_matches_jax_and_engine(jax_lanes, method):
    """Every lane's pass boundary with the lane-axis solve: against JAX's
    batched_increment_pass with the same method, and to the bit against
    the port's engine reoptimize of each lane. ("dense" against JAX:
    tests/test_torch_batch.py.)"""
    jcfg, tcfg, js, counts = jax_lanes
    ts = tckpt.state_from_numpy(_flatten_state(js), tcfg, "cpu", lanes=len(counts))
    jout = jb.batched_increment_pass(jcfg, js, solve_method=method, use_kernel=False)
    tout = tb.batched_increment_pass(tcfg, ts, solve_method=method)
    for i, n in enumerate(counts):
        jl, tl = jb.session_state(jout, i), tb.session_state(tout, i)
        ne = int(jl.graph.num_edges)
        assert int(tl.graph.num_edges) == ne
        np.testing.assert_array_equal(tl.graph.edge_idx[:ne].numpy(), np.asarray(jl.graph.edge_idx[:ne]))
        _assert_poses_close(tl.poses[:n].numpy(), np.asarray(jl.poses[:n]), POSE_TOL)
    _assert_lanes_equal_engine(tcfg, ts, tout, method)


def test_batched_increment_pass_dense_pallas_equals_engine(jax_lanes):
    """With "dense_pallas" (one spd_solve of every lane's system an LM
    iteration) the pass boundary still equals the engine's per lane."""
    _, tcfg, js, counts = jax_lanes
    ts = tckpt.state_from_numpy(_flatten_state(js), tcfg, "cpu", lanes=len(counts))
    _assert_lanes_equal_engine(tcfg, ts, tb.batched_increment_pass(tcfg, ts, solve_method="dense_pallas"),
                               "dense_pallas")
