"""parallel/ across processes: dpg_slam_tpu_torch.parallel.multihost and the
distributed solvers on a torch.distributed process group, on the CPU over
gloo (the counterpart of tests/test_multihost.py's two-process
jax.distributed job).

Two processes of one thread each join a gloo group; each holds 4 of an
8-shard mesh (global_mesh(8)) and runs distributed_solve (edge-sharded
CG), schur_solve and distributed_reoptimize on tests/test_torch_distributed.py's
and tests/test_torch_schur.py's small fixtures, with jax unimportable.
Tolerances: every result on both ranks equals the one-process 8-shard
result (make_mesh(8, "cpu")) to the bit (each psum is an all_gather in
shard order and the one-process sum, parallel/mesh.py); against the JAX
package's 8-device virtual mesh the bounds of those files: distributed_solve
and schur_solve poses atol 1e-4 (schur_solve's separator counts equal),
distributed_reoptimize 2e-3 m / rad.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu import engine as jeng
from dpg_slam_tpu.config import CapacityParams
from dpg_slam_tpu.io import dataset as jds
from dpg_slam_tpu.parallel import make_mesh as jmake_mesh
from dpg_slam_tpu.parallel.distributed import distributed_reoptimize as jdistributed_reoptimize
from dpg_slam_tpu.parallel.distributed import distributed_solve as jdistributed_solve
from dpg_slam_tpu.parallel.partition import spatial_blocks as jspatial_blocks
from dpg_slam_tpu.parallel.schur import schur_solve as jschur_solve
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.parallel import distributed_reoptimize, distributed_solve, make_mesh, schur_solve
from dpg_slam_tpu_torch.parallel import mesh as mesh_mod
from dpg_slam_tpu_torch.parallel import multihost
from dpg_slam_tpu_torch.utils.checkpoint import state_from_numpy

from test_engine import run_sequence, small_config
from test_graph import build_gtsam_fixture
from test_schur import outlier_graph
from test_torch_distributed import _random_graph
from test_torch_schur import _FIXTURES as SCHUR_FIXTURES
from test_torch_schur import _KW as SCHUR_KW

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS, SHARDS = 2, 8
FACTORS = ("prior_idx", "prior_val", "prior_sqrt_info", "prior_mask",
           "edge_idx", "edge_meas", "edge_sqrt_info", "edge_mask")
SOLVE_KW = {
    "gtsam": dict(max_iterations=30),
    "random": dict(max_iterations=30),
    "outlier": dict(max_iterations=5, cg_iterations=64, robust_delta=2.0, rel_tol=1e-8),
}
SCHUR_CASES = [f"{name}_{pallas}" for name in SCHUR_FIXTURES for pallas in ("xla", "pallas")]
REOPT_SOLVERS = ("schur", "cg")

_CHILD = r"""
import json, os, sys
sys.modules["jax"] = None  # the port's ranks run without JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.parallel import distributed_reoptimize, distributed_solve, schur_solve
from dpg_slam_tpu_torch.parallel.mesh import gather_shards
from dpg_slam_tpu_torch.parallel.multihost import global_mesh, initialize_multihost
from dpg_slam_tpu_torch.utils.checkpoint import state_from_numpy

assert initialize_multihost(device="cpu")
rank = int(os.environ["RANK"])
mesh = global_mesh()
assert (mesh.size, mesh.world, mesh.rank, mesh.shards) == (2, 2, rank, (rank, rank + 1)), mesh
total = float(gather_shards(mesh, torch.tensor([rank + 1.0])).sum())
print(f"rank {rank} OK sum={total}", flush=True)

mesh = global_mesh(8)
assert mesh.shards == (4 * rank, 4 * rank + 4)
inp = dict(np.load(sys.argv[1]))
spec = json.loads(inp.pop("spec").item())
t = lambda key: torch.from_numpy(inp[key])
out = {}
for name, kw in spec["solve"].items():
    out[f"solve_{name}"] = distributed_solve(mesh, t(f"{name}/init"), t(f"{name}/mask"),
                                             *(t(f"{name}/{f}") for f in spec["factors"]), **kw).numpy()
for case, kw in spec["schur"].items():
    name, elim = case.rsplit("_", 1)
    assign = t(f"{name}/assign") if f"{name}/assign" in inp else None
    poses, sep, iters = schur_solve(mesh, t(f"{name}/init"), t(f"{name}/mask"),
                                    *(t(f"{name}/{f}") for f in spec["factors"]), assign,
                                    pallas_elimination=elim == "pallas", **kw)
    out[f"schur_{case}"], out[f"schur_{case}/sep"] = poses.numpy(), np.int64(sep)
cfg = DpgConfig.from_json(spec["config"])
state = state_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("state/")}, cfg, "cpu")
for solver in spec["reoptimize"]:
    res = distributed_reoptimize(mesh, cfg, state, solver=solver)
    out[f"reoptimize_{solver}"], out[f"reoptimize_{solver}/edges"] = res.poses.numpy(), res.graph.edge_idx.numpy()
np.savez(sys.argv[2], **out)
print(f"rank {rank} done", flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run on one thread; so does the one-process reference."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_arrays(name, g, init, mask, assign=None) -> dict:
    arrays = {f"{name}/{f}": np.asarray(getattr(g, f)) for f in FACTORS}
    arrays.update({f"{name}/init": np.asarray(init, np.float32), f"{name}/mask": np.asarray(mask)})
    if assign is not None:
        arrays[f"{name}/assign"] = np.asarray(assign)
    return arrays


def _two_pass_state():
    """tests/test_torch_distributed.py's two_pass fixture: the JAX engine
    after two passes of the office loop (the second at every other scan)."""
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fixtures through two gloo ranks (started first, in the
    background), the port's one process and the JAX package's 8-device
    mesh: {"ranks": [rank outputs], "logs": [...], "one": {...}, "jax": {...}}."""
    tmp = tmp_path_factory.mktemp("ranks")
    graphs = {
        "gtsam": build_gtsam_fixture(capacity_nodes=8, capacity_edges=16),
        "random": _random_graph(),
        "outlier": outlier_graph()[:3],
    }
    arrays = {}
    for name, (g, init, mask) in graphs.items():
        arrays.update(_graph_arrays(name, g, init, mask))
    schur_graphs = {}
    for name, make in SCHUR_FIXTURES.items():
        g, init, mask, gt = make()
        assign = jspatial_blocks(gt[:, :2], np.ones(gt.shape[0], bool), SHARDS) if name == "laps" else None
        schur_graphs[name] = (g, init, mask, assign)
        arrays.update(_graph_arrays(f"s_{name}", g, init, mask, assign))
    jcfg, jstate = _two_pass_state()
    tcfg = TorchConfig.from_json(jcfg.to_json())
    flat = _flatten_state(jstate)
    arrays.update({f"state/{k}": v for k, v in flat.items()})
    spec = dict(
        factors=FACTORS, solve=SOLVE_KW, reoptimize=REOPT_SOLVERS, config=jcfg.to_json(),
        schur={f"s_{case}": SCHUR_KW[case.rsplit("_", 1)[0]] for case in SCHUR_CASES},
    )
    arrays["spec"] = np.array(json.dumps(spec))
    np.savez(tmp / "inputs.npz", **arrays)

    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(RANKS),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(tmp / "inputs.npz"), str(tmp / f"rank{rank}.npz")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))

    def t(x):
        return torch.from_numpy(np.array(x))

    one, want = {}, {}
    try:
        mesh, jmesh = make_mesh(SHARDS, "cpu"), jmake_mesh(SHARDS)
        for name, (g, init, mask) in graphs.items():
            factors = [getattr(g, f) for f in FACTORS]
            one[f"solve_{name}"] = distributed_solve(mesh, t(init), t(mask), *map(t, factors),
                                                     **SOLVE_KW[name]).numpy()
            want[f"solve_{name}"] = np.asarray(jdistributed_solve(jmesh, init, mask, *factors, **SOLVE_KW[name]))
        for case in SCHUR_CASES:
            name, elim = case.rsplit("_", 1)
            g, init, mask, assign = schur_graphs[name]
            factors = [getattr(g, f) for f in FACTORS]
            a = None if assign is None else jnp.asarray(assign)
            p, sep, _ = schur_solve(mesh, t(init), t(mask), *map(t, factors), None if assign is None else t(assign),
                                    pallas_elimination=elim == "pallas", **SCHUR_KW[name])
            one[f"schur_s_{case}"], one[f"schur_s_{case}/sep"] = p.numpy(), sep
            jp, jsep, _ = jschur_solve(jmesh, init, mask, *factors, a, pallas_elimination=elim == "pallas",
                                       pallas_interpret=True, **SCHUR_KW[name])
            want[f"schur_s_{case}"], want[f"schur_s_{case}/sep"] = np.asarray(jp), int(jsep)
        tstate = state_from_numpy(flat, tcfg, "cpu")
        for solver in REOPT_SOLVERS:
            res = distributed_reoptimize(mesh, tcfg, tstate, solver=solver)
            one[f"reoptimize_{solver}"] = res.poses.numpy()
            one[f"reoptimize_{solver}/edges"] = res.graph.edge_idx.numpy()
            want[f"reoptimize_{solver}"] = np.asarray(
                jdistributed_reoptimize(jmesh, jcfg, jstate, solver=solver).poses)
    finally:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    ranks = [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(RANKS)]
    return dict(ranks=ranks, logs=logs, one=one, jax=want, n_nodes=int(jstate.num_nodes))


def test_initialize_without_environment_returns_false(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost(device="cpu") is False
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        multihost.global_mesh()


def test_card_backend_never_falls_back_to_gloo(monkeypatch):
    """device="cuda" joins over NCCL or raises; without a card it raises
    before any process group is made (no quiet gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        multihost.initialize_multihost("127.0.0.1:1", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="process count"):
        multihost.initialize_multihost("127.0.0.1:1", None, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_mesh_shard_ranges():
    one = make_mesh(8, "cpu")
    assert (one.group, one.rank, one.world, one.shards) == (None, 0, 1, (0, 8))
    x = torch.arange(8.0)
    assert mesh_mod.gather_shards(one, x) is x
    ranked = mesh_mod.Mesh(8, torch.device("cpu"), object(), 1, 2)
    assert ranked.shards == (4, 8)


def test_two_process_sum(runs):
    for rank, log in enumerate(runs["logs"]):
        assert f"rank {rank} OK sum=3.0" in log and f"rank {rank} done" in log, log


def _assert_poses_close(t, j, atol):
    np.testing.assert_allclose(t[:, :2], j[:, :2], atol=atol)
    np.testing.assert_allclose(np.angle(np.exp(1j * (t[:, 2].astype(np.float64) - j[:, 2]))), 0.0, atol=atol)


@pytest.mark.parametrize("name", list(SOLVE_KW))
def test_distributed_solve_two_ranks(runs, name):
    key = f"solve_{name}"
    for out in runs["ranks"]:
        np.testing.assert_array_equal(out[key], runs["one"][key])
    np.testing.assert_allclose(runs["ranks"][0][key], runs["jax"][key], atol=1e-4)


@pytest.mark.parametrize("case", SCHUR_CASES)
def test_schur_solve_two_ranks(runs, case):
    key = f"schur_s_{case}"
    for out in runs["ranks"]:
        np.testing.assert_array_equal(out[key], runs["one"][key])
        assert int(out[f"{key}/sep"]) == runs["one"][f"{key}/sep"] == runs["jax"][f"{key}/sep"] > 0
    np.testing.assert_allclose(runs["ranks"][0][key], runs["jax"][key], atol=1e-4)


@pytest.mark.parametrize("solver", REOPT_SOLVERS)
def test_distributed_reoptimize_two_ranks(runs, solver):
    key = f"reoptimize_{solver}"
    n = runs["n_nodes"]
    for out in runs["ranks"]:
        np.testing.assert_array_equal(out[key], runs["one"][key])
        np.testing.assert_array_equal(out[f"{key}/edges"], runs["one"][f"{key}/edges"])
    _assert_poses_close(runs["ranks"][0][key][:n], runs["jax"][key][:n], 2e-3)
