"""Port parity: dpg_slam_tpu_torch.bench_scaling against
dpg_slam_tpu/bench_scaling.py on the CPU.

- build_big_graph at N = 256: indices, counts, masks and sqrt-information
  equal; ground truth, measurements and initial poses within 1e-4 m / rad
  (the chain is composed in float32 by each package's own sin / cos).
- comm_structure_study equal row for row; crossover_study equal to the
  JAX package's when given its constants, and the port's CHIP holds none
  of them.
- The timing rows of main at mesh sizes 1, 2 and 4, at N = 256 and 64,
  against the JAX package's solvers on its graph, one subprocess per
  solver family (as the JAX harness runs its families), each with its
  own budget search: gn_budget, separators and converged_lm_iters equal
  (a gn_budget one step apart only where a max_err_m lies within 1e-3 of
  --tol); max_err_m within --tol. At N = 64 both families are well
  conditioned: poses within tests/test_torch_distributed.py's and
  tests/test_torch_schur.py's 1e-4, max_err_m within 1e-3. At N = 256:
  - CG: max_err_m within 1e-3, poses within 5e-4 (ten LM steps of a
    48-step PCG on float32 sums in another order end 0.6-1.5e-4 apart;
    the port's float64 run lies 6e-5 from its float32 one);
  - Schur: the chain system is ill-conditioned in float32 (one GN step of
    either package lies 2-4e-3 m from the float64 step, and the two
    packages' LM runs end up to 2.2e-2 m apart, JAX's own runs of one
    input up to 4e-3 apart), so both packages' poses are held to the
    port's float64 solve at the same budget, within --tol.
- Two gloo ranks under torchrun's variables (one thread each, as
  tests/test_torch_multihost.py runs them): the mesh-4 row (two shards a
  rank) equal to the one-process run to the bit, the mesh-2 row (one
  shard a rank: a batched matmul over one matrix rounds otherwise) within
  1e-5.
"""

import contextlib
import inspect
import io
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpg_slam_tpu import bench_scaling as jb
from dpg_slam_tpu_torch import bench_scaling as tb
from dpg_slam_tpu_torch.parallel import make_mesh, schur_solve

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, MESHES, TOL = 256, (1, 2, 4), 0.03
SMALL_N = 64
NEAR = 1e-3
CG_POSE_TOL = {256: 5e-4, 64: 1e-4}
FACTORS = ("prior_idx", "prior_val", "prior_sqrt_info", "prior_mask",
           "edge_idx", "edge_meas", "edge_sqrt_info", "edge_mask")

# The JAX package's solvers on its own graph, for one family: the budget
# search of its harness (budgets 5-40 until max_err <= tol, against the
# graph's own ground truth), separators and the rel_tol=1e-5 iteration
# count for Schur, and the poses at the budget found.
_JAX_FAMILY = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from dpg_slam_tpu import bench_scaling as jb
from dpg_slam_tpu.parallel import make_mesh
from dpg_slam_tpu.parallel.distributed import distributed_solve
from dpg_slam_tpu.parallel.schur import schur_solve

family, out_path = sys.argv[1], sys.argv[4]
sizes = [int(n) for n in sys.argv[2].split(",")]
meshes = [int(n) for n in sys.argv[3].split(",")]
rows, out = {}, {}
for N in sizes:
    if family == "cg":
        g, init, mask, gt = jb.build_big_graph(N, N)
    else:
        g, init, mask, gt = jb.build_big_graph(N, N, closures_per_node=0, seed=1)
    factors = (g.prior_idx, g.prior_val, g.prior_sqrt_info, g.prior_mask,
               g.edge_idx, g.edge_meas, g.edge_sqrt_info, g.edge_mask)
    rows[N] = []
    for n in meshes:
        mesh = make_mesh(n)
        def solve(budget, rel_tol=0.0):
            if family == "cg":
                return distributed_solve(mesh, init, mask, *factors, max_iterations=budget), None, None
            return schur_solve(mesh, init, mask, *factors, sep_cap=max(8 * n, 16), max_iterations=budget,
                               rel_tol=rel_tol)
        for budget in (5, 10, 20, 40):
            poses, sep, _ = solve(budget)
            poses = np.asarray(poses)
            err = float(np.linalg.norm(poses[:N, :2] - gt[:, :2], axis=1).max())
            if err <= 0.03:
                break
        row = dict(mesh=n, gn_budget=budget, max_err_m=err)
        if family == "schur":
            row.update(separators=int(sep), converged_lm_iters=int(solve(10, rel_tol=1e-5)[2]))
        rows[N].append(row)
        out[f"{N}/{n}"] = poses
np.savez(out_path, rows=np.array(json.dumps(rows)), **out)
"""

_RANK = r"""
import json, sys
sys.modules["jax"] = None  # the port's ranks run without JAX
import numpy as np
import torch
torch.set_num_threads(1)
from dpg_slam_tpu_torch import bench_scaling as bs

real, got = bs.run, {}
def capture(args):
    got["out"] = real(args)
    return got["out"]
bs.run = capture
assert bs.main(json.loads(sys.argv[1])) == 0
results, solves, rank = got["out"]
np.savez(sys.argv[2], rows=np.array(json.dumps(results["distributed_solve"])), rank=rank,
         **{f"{family}_{n}": np.stack([p.numpy() for p in outs]) for (family, n), outs in solves.items()})
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's runs here take one thread: their ops are small, and more
    threads only contend with the JAX subprocesses and the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start_jax(family, tmp):
    out = tmp / f"jax_{family}.npz"
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FAMILY, family, f"{N},{SMALL_N}",
                             ",".join(map(str, MESHES)), str(out)],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def _finish(proc, out):
    """{N: (JAX rows, {mesh: JAX poses})} of one family's subprocess."""
    log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log
    with np.load(out) as z:
        rows = json.loads(z["rows"].item())
        poses = {tuple(map(int, k.split("/"))): z[k] for k in z.files if k != "rows"}
    return {int(n): (r, {m: p for (size, m), p in poses.items() if size == int(n)}) for n, r in rows.items()}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Both families through the port's harness (run, on the CPU) and
    through the JAX package's solvers in one subprocess per family, at
    N = 256 and 64: {n: (port results, port solves, {family: (JAX rows,
    JAX poses)})}."""
    tmp = tmp_path_factory.mktemp("scaling")
    procs = {fam: _start_jax(fam, tmp) for fam in ("cg", "schur")}
    try:
        port = {}
        for n in (N, SMALL_N):
            argv = ["--device", "cpu", "--nodes", str(n), "--mesh-sizes", *map(str, MESHES), "--repeats", "1"]
            results, solves, rank = tb.run(tb.parse_args(argv))
            assert rank == 0
            port[n] = (results, solves)
    finally:
        jax_out = {fam: _finish(*p) for fam, p in procs.items()}
    return {n: (*port[n], {fam: jax_out[fam][n] for fam in ("cg", "schur")}) for n in (N, SMALL_N)}


def _graph_arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in FACTORS + ("num_edges", "num_priors")}


@pytest.mark.parametrize("seed,closures", [(0, 0), (0, 2), (1, 0), (1, 2)])
def test_build_big_graph_matches_jax(seed, closures):
    jg, jinit, jmask, jgt = jb.build_big_graph(N, N, closures, seed)
    tg, tinit, tmask, tgt = tb.build_big_graph(N, N, closures, seed, device="cpu")
    assert tinit.device.type == "cpu" and tinit.dtype == torch.float32
    want = _graph_arrays(jg)
    got = {f: np.asarray(getattr(tg, f)) for f in want}
    for f in ("edge_idx", "edge_mask", "prior_idx", "prior_mask", "edge_sqrt_info", "prior_sqrt_info", "prior_val",
              "num_edges", "num_priors"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(tg.num_edges) == N - 1 + (N * closures) // 4
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tgt, jgt, atol=1e-4)
    np.testing.assert_allclose(got["edge_meas"], want["edge_meas"], atol=1e-4)
    np.testing.assert_allclose(tinit.numpy(), np.asarray(jinit), atol=1e-4)


def test_comm_structure_matches_jax():
    want = jb.comm_structure_study()
    assert tb.comm_structure_study() == want and len(want) == 18


def test_crossover_matches_jax_with_its_constants():
    assert tb.crossover_study(chip=dict(jb.CHIP)) == jb.crossover_study()
    assert tb.crossover_model(4096, 8, 30, 48, chip=dict(jb.CHIP)) == jb.crossover_model(4096, 8, 30, 48)


def test_chip_holds_no_tpu_constant():
    assert tb.CHIP.keys() == jb.CHIP.keys()
    for key, value in jb.CHIP.items():
        assert tb.CHIP[key] != value, key
    assert tb.crossover_study() != jb.crossover_study()
    assert inspect.signature(tb.crossover_study).parameters["chip"].default is tb.CHIP


def _near(a, b):
    return abs(a - b) <= NEAR


def _check_common(row, jrow, family):
    """gn_budget (and for Schur separators and converged_lm_iters) equal,
    or one step apart where the row sits within NEAR of a threshold."""
    assert row["mesh"] == jrow["mesh"]
    if row["gn_budget"] != jrow["gn_budget"]:
        budgets = list(tb.BUDGETS)
        assert _near(row["max_err_m"], TOL) or _near(jrow["max_err_m"], TOL), (row, jrow)
        assert abs(budgets.index(row["gn_budget"]) - budgets.index(jrow["gn_budget"])) == 1, (row, jrow)
    if family == "schur":
        assert row["separators"] == jrow["separators"]
        assert row["converged_lm_iters"] == jrow["converged_lm_iters"], (row, jrow)


def _pose_dist(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = np.angle(np.exp(1j * d[:, 2]))
    return float(np.abs(d).max())


@pytest.mark.parametrize("mesh", MESHES)
def test_cg_rows_match_jax(rows, mesh):
    for n in (N, SMALL_N):
        results, solves, jax_out = rows[n]
        jrows, jposes = jax_out["cg"]
        row = next(r for r in results["distributed_solve"] if r["mesh"] == mesh)
        jrow = next(r for r in jrows if r["mesh"] == mesh)
        _check_common(row, jrow, "cg")
        assert abs(row["max_err_m"] - jrow["max_err_m"]) <= 1e-3
        assert row["max_err_m"] <= TOL
        if row["gn_budget"] == jrow["gn_budget"]:
            np.testing.assert_allclose(solves["cg", mesh][0].numpy(), jposes[mesh], atol=CG_POSE_TOL[n])


@pytest.mark.parametrize("mesh", MESHES)
def test_schur_rows_match_jax(rows, mesh):
    for n in (N, SMALL_N):
        results, solves, jax_out = rows[n]
        jrows, jposes = jax_out["schur"]
        row = next(r for r in results["schur_solve_chain"] if r["mesh"] == mesh)
        jrow = next(r for r in jrows if r["mesh"] == mesh)
        _check_common(row, jrow, "schur")
        assert row["max_err_m"] <= TOL and jrow["max_err_m"] <= TOL
        if row["gn_budget"] != jrow["gn_budget"]:
            continue
        poses = solves["schur", mesh][0].numpy()
        if n == SMALL_N:
            np.testing.assert_allclose(poses, jposes[mesh], atol=1e-4)
            assert abs(row["max_err_m"] - jrow["max_err_m"]) <= 1e-3
            continue
        g, init, mask, _ = tb.build_big_graph(n, n, closures_per_node=0, seed=1, device="cpu")
        f64 = [x.double() if x.is_floating_point() else x for x in (getattr(g, f) for f in FACTORS)]
        ref, _, _ = schur_solve(make_mesh(mesh, "cpu"), init.double(), mask, *f64, sep_cap=max(8 * mesh, 16),
                                max_iterations=row["gn_budget"])
        assert _pose_dist(poses, ref) <= TOL
        assert _pose_dist(jposes[mesh], ref) <= TOL


def test_results_keys_and_rows(rows):
    results, solves, _ = rows[N]
    assert list(results) == ["nodes", "edges", "backend", "device", "distributed_solve", "schur_solve_chain",
                             "comm_structure", "crossover", "physical_cores", "note"]
    assert (results["nodes"], results["edges"], results["backend"], results["device"]) == (N, 383, "cpu", "cpu")
    assert [r["mesh"] for r in results["distributed_solve"]] == [r["mesh"] for r in results["schur_solve_chain"]] \
        == list(MESHES)
    assert results["comm_structure"] == tb.comm_structure_study()
    assert results["crossover"] == tb.crossover_study()
    assert sorted(solves) == sorted((fam, n) for fam in ("cg", "schur") for n in MESHES)
    for outs in solves.values():
        assert len(outs) == 1 and outs[0].shape == (N, 3) and torch.isfinite(outs[0]).all()


def test_structure_only_prints_only_comm_structure():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tb.main(["--structure-only"]) == 0
    assert json.loads(buf.getvalue()) == {"comm_structure": jb.comm_structure_study()}


def test_default_device_is_the_card():
    assert tb.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tb.main(["--nodes", "64", "--mesh-sizes", "1", "--repeats", "1"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """main at N = 64, --family cg, mesh sizes 2 and 4, on two gloo ranks
    and in this process (one thread each)."""
    tmp = tmp_path_factory.mktemp("ranks")
    argv = ["--device", "cpu", "--nodes", str(SMALL_N), "--family", "cg", "--mesh-sizes", "2", "4", "--repeats", "1"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, json.dumps(argv), str(tmp / f"rank{rank}.npz")],
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                 LOCAL_RANK=str(rank)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for rank in range(2)]
    try:
        results, solves, _ = tb.run(tb.parse_args(argv))
    finally:
        logs = [p.communicate(timeout=150) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}\n{err}"
    ranks = [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(2)]
    return dict(ranks=ranks, stdout=[out for out, _ in logs], one=(results, solves))


def test_two_ranks_print_once(two_ranks):
    printed = json.loads(two_ranks["stdout"][0])
    assert printed["distributed_solve"] == json.loads(two_ranks["ranks"][0]["rows"].item())
    assert printed["schur_solve_chain"] == [] and printed["backend"] == "cpu"
    assert two_ranks["stdout"][1] == ""
    assert [int(r["rank"]) for r in two_ranks["ranks"]] == [0, 1]


@pytest.mark.parametrize("mesh", [2, 4])
def test_two_ranks_equal_one_process(two_ranks, mesh):
    results, solves = two_ranks["one"]
    one_row = next(r for r in results["distributed_solve"] if r["mesh"] == mesh)
    want = solves["cg", mesh][0].numpy()
    for rank_out in two_ranks["ranks"]:
        row = next(r for r in json.loads(rank_out["rows"].item()) if r["mesh"] == mesh)
        got = rank_out[f"cg_{mesh}"][0]
        assert row["gn_budget"] == one_row["gn_budget"]
        if mesh == 4:
            np.testing.assert_array_equal(got, want)
            assert row["max_err_m"] == one_row["max_err_m"]
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)
        assert row.get("oversubscribed_structural_only") == one_row.get("oversubscribed_structural_only")
