"""Port parity: dpg_slam_tpu_torch.parallel (sharded ICP, edge-sharded CG,
distributed reoptimize) against the JAX package on its virtual 8-device CPU
mesh, on the same seeded inputs. In the port a mesh is S shards on one
device (parallel/mesh.py).

Tolerances:
- sharded_icp_align: identical to the port's own icp_align (one call);
- distributed_solve: atol 1e-4 on poses (float32 PCG with a fixed
  iteration count, sums in another order);
- distributed_reoptimize: 2e-3 m / rad, the bound of the port's
  single-device reoptimize parity test (tests/test_torch_engine.py): the
  ICP sweep differs by ~1e-5 m a pair and feeds a full LM solve.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu import engine as jeng
from dpg_slam_tpu.config import CapacityParams
from dpg_slam_tpu.graph import factor_graph as jfg
from dpg_slam_tpu.io import dataset as jds
from dpg_slam_tpu.parallel import make_mesh as jmake_mesh
from dpg_slam_tpu.parallel.distributed import distributed_reoptimize as jdistributed_reoptimize
from dpg_slam_tpu.parallel.distributed import distributed_solve as jdistributed_solve
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu_torch import engine as teng
from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig, PoseGraphParams
from dpg_slam_tpu_torch.ops import icp
from dpg_slam_tpu_torch.parallel import distributed_reoptimize, distributed_solve, make_mesh, sharded_icp_align
from dpg_slam_tpu_torch.utils.checkpoint import state_from_numpy

from test_engine import run_sequence, small_config
from test_graph import build_gtsam_fixture
from test_icp import make_room_scan
from test_schur import outlier_graph


def _t(x):
    return torch.from_numpy(np.array(x))


def test_make_mesh():
    assert inspect.signature(make_mesh).parameters["device"].default == "cuda"
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.device.type == "cpu"
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def test_sharded_icp_matches_icp_align():
    rng = np.random.default_rng(0)
    B = 8
    tgt = np.stack([make_room_scan(rng, n=64) for _ in range(B)]).astype(np.float32)
    pose = torch.tensor(rng.uniform(-0.3, 0.3, (B, 3)), dtype=torch.float32)
    tgt_t = torch.from_numpy(tgt)
    src = geom.inv_apply(pose, tgt_t)
    mask = torch.ones((B, 64), dtype=torch.bool)
    args = (src, mask, tgt_t, mask, torch.zeros((B, 3)), PoseGraphParams())
    single = icp.icp_align(*args)
    sharded = sharded_icp_align(make_mesh(8, "cpu"), *args)
    for a, b in zip(single, sharded):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        sharded_icp_align(make_mesh(3, "cpu"), *args)


def _random_graph():
    """tests/test_distributed.py's random chain + closures graph."""
    rng = np.random.default_rng(7)
    N, cap = 24, 32
    g = jfg.empty_graph(max_priors=4, max_edges=64)
    g = jfg.add_prior(g, jnp.int32(0), jnp.zeros(3), jfg.sqrt_info_from_sigmas(jnp.array([0.1, 0.1, 0.05])))
    gt = np.cumsum(rng.uniform(-0.5, 1.0, (N, 3)) * np.array([1, 0.3, 0.3]), axis=0)
    gt[0] = 0
    model = jfg.sqrt_info_from_sigmas(jnp.array([0.1, 0.1, 0.05]))
    from dpg_slam_tpu import geom as jgeom

    pairs = [(i, i + 1) for i in range(N - 1)] + [tuple(sorted(rng.choice(N, 2, replace=False))) for _ in range(10)]
    for i, j in pairs:
        g = jfg.add_between(g, jnp.int32(i), jnp.int32(j), jgeom.between(jnp.array(gt[i]), jnp.array(gt[j])), model)
    init = jnp.zeros((cap, 3)).at[:N].set(jnp.array(gt + rng.normal(0, 0.1, (N, 3)), jnp.float32))
    return g, init, jnp.arange(cap) < N


@pytest.mark.parametrize("fixture", ["gtsam", "random", "outlier"])
def test_distributed_solve_matches_jax(fixture):
    kw = dict(max_iterations=30)
    if fixture == "gtsam":
        g, init, mask = build_gtsam_fixture(capacity_nodes=8, capacity_edges=16)
    elif fixture == "random":
        g, init, mask = _random_graph()
    else:
        # Huber IRLS on the stiff outlier chain. Its 64-step PCG stays far
        # from converged (both packages end 4-5e-3 from the dense optimum
        # after 30 LM steps), so float32 rounding grows over the steps:
        # 1e-5 apart after 5, 9e-4 after 30. Five steps keep the bound.
        g, init, mask, _ = outlier_graph()
        kw.update(max_iterations=5, cg_iterations=64, robust_delta=2.0, rel_tol=1e-8)
    factors = [g.prior_idx, g.prior_val, g.prior_sqrt_info, g.prior_mask,
               g.edge_idx, g.edge_meas, g.edge_sqrt_info, g.edge_mask]
    jp = jdistributed_solve(jmake_mesh(8), init, mask, *factors, **kw)
    tp = distributed_solve(make_mesh(8, "cpu"), _t(init), _t(mask), *[_t(f) for f in factors], **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)


@pytest.fixture(scope="module")
def two_pass():
    """The JAX engine after two passes of the office loop (the second at
    every other scan), as in tests/test_torch_engine.py, and its config."""
    jcfg = small_config().replace(capacity=CapacityParams(max_nodes=128, max_edges=1024, max_priors=8))
    seq = jds.simulate_sequence(
        jds.make_office_world(), jds.office_loop_waypoints(), jcfg.scan, step=0.5, seed=1,
        odom_noise_transl=0.02, odom_noise_rot=0.008,
    )
    je = jeng.DpgSlamEngine(jcfg)
    run_sequence(je, seq)
    je._dpg_enabled = False
    je.increment_pass()
    run_sequence(je, seq, stride=2)
    return jcfg, je.state


def _assert_poses_close(t, j, atol):
    np.testing.assert_allclose(t[:, :2], j[:, :2], atol=atol)
    dth = np.angle(np.exp(1j * (t[:, 2].astype(np.float64) - j[:, 2])))
    np.testing.assert_allclose(dth, 0.0, atol=atol)


@pytest.mark.parametrize("solver", ["schur", "schur_pallas", "cg"])
def test_distributed_reoptimize_matches_jax(two_pass, solver):
    jcfg, jstate = two_pass
    tcfg = TorchConfig.from_json(jcfg.to_json())
    tstate = state_from_numpy(_flatten_state(jstate), tcfg, "cpu")
    kind, pallas = solver.split("_")[0], solver.endswith("pallas")
    jout = jdistributed_reoptimize(jmake_mesh(8), jcfg, jstate, solver=kind, pallas_elimination=pallas)
    tout = distributed_reoptimize(make_mesh(8, "cpu"), tcfg, tstate, solver=kind, pallas_elimination=pallas)
    n = int(jstate.num_nodes)
    assert int(tout.graph.num_edges) == int(jout.graph.num_edges) > n
    _assert_poses_close(tout.poses[:n].numpy(), np.asarray(jout.poses[:n]), 2e-3)


def test_engine_with_mesh_reoptimizes_over_it(two_pass):
    jcfg, jstate = two_pass
    tcfg = TorchConfig.from_json(jcfg.to_json())
    mesh = make_mesh(8, "cpu")
    eng = teng.DpgSlamEngine(tcfg, "cpu", mesh=mesh)
    eng.state = state_from_numpy(_flatten_state(jstate), tcfg, "cpu")
    want = distributed_reoptimize(mesh, tcfg, eng.state)
    eng.increment_pass()
    assert torch.equal(eng.state.poses, want.poses)
    assert int(eng.state.pass_number) == int(jstate.pass_number) + 1
    with pytest.raises(ValueError, match="max_edges"):
        teng.DpgSlamEngine(tcfg, "cpu", mesh=make_mesh(3, "cpu"))
    with pytest.raises(ValueError, match="mesh"):
        distributed_reoptimize(make_mesh(8), tcfg, eng.state)
