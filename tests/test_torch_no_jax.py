"""The port stands without JAX: no module of dpg_slam_tpu_torch (nor
chip_smoke.py) imports jax or dpg_slam_tpu, the package runs keyframes, a
second pass with DPG change detection and its map layers, the offline
sequence mode, the session-batched mode, the online server and the
multipass batched mode in a process where jax cannot be imported, and chip_smoke.py refuses to run without a CUDA card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dpg_slam_tpu_torch"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {PKG / "dpg" / "change_detection.py", PKG / "ops" / "raster.py", PKG / "graph" / "segment.py"} <= set(files)
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "dpg_slam_tpu"}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from dpg_slam_tpu_torch.config import CapacityParams, DpgConfig, DpgParams, PoseGraphParams, ScanParams
from dpg_slam_tpu_torch.engine import DpgSlamEngine
from dpg_slam_tpu_torch.io import dataset

cfg = DpgConfig(
    scan=ScanParams(num_beams=128),
    pose_graph=PoseGraphParams(icp_max_points=32, icp_maximum_iterations=10, max_loop_closures_per_node=2),
    dpg=DpgParams(max_submap_nodes=8),
    capacity=CapacityParams(max_nodes=16, max_edges=64, max_priors=4),
)
seq = dataset.simulate_sequence(
    dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan, step=0.5, seed=1
)
eng = DpgSlamEngine(cfg, "cpu")
t = 0
while eng.num_nodes() < 3:
    eng.observe_odometry(seq.odometry[t])
    eng.observe_laser(seq.scans[t])
    t += 1
traj = eng.trajectory()
assert traj.shape == (3, 3) and np.isfinite(traj).all()

# A second pass with DPG on (the default) and its map layers.
eng.increment_pass()
t = 0
while eng.num_nodes() < 5:
    eng.observe_odometry(seq.odometry[t])
    eng.observe_laser(seq.scans[t])
    t += 1
assert eng.last_dpg_info is not None and int(eng.last_dpg_info.num_contributors) > 0
layers = eng.map_layers()
assert len(layers["active_static"]) > 0

# The offline sequence mode and the session-batched mode, on 12 scans.
from dpg_slam_tpu_torch import batch
seqs = [seq, dataset.simulate_sequence(dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan,
                                       step=0.5, seed=2)]
off = DpgSlamEngine(cfg, "cpu")
kf = off.process_sequence(seq.odometry[:12], seq.scans[:12])
states, counts = batch.process_sessions_batched(cfg, [(s.odometry[:12], s.scans[:12]) for s in seqs], device="cpu")
assert counts[0] == int(kf.sum()) == off.num_nodes() == int(batch.session_state(states, 0).num_nodes) >= 3
assert np.isfinite(states.poses.numpy()).all()

# The online server in immediate mode on the same 12 ticks.
srv = batch.BatchedSlamServer(cfg, 2, min_batch_fraction=1e-9, device="cpu")
for t in range(12):
    srv.observe(np.stack([s.odometry[t] for s in seqs]), np.stack([s.scans[t] for s in seqs]))
srv.flush()
assert [srv.num_nodes(i) for i in range(2)] == counts and srv.keyframes_executed == sum(counts)

# The multipass batched mode: two lanes, two passes of 8 scans each, DPG on pass 1.
lane_passes = [[(s.odometry[:8], s.scans[:8]), (s.odometry[8:16], s.scans[8:16])] for s in seqs]
multi, multi_counts = batch.process_sessions_multipass(cfg, lane_passes, device="cpu")
assert [sum(c) for c in multi_counts] == multi.num_nodes.tolist() and min(min(c) for c in multi_counts) >= 1
assert multi.pass_number.tolist() == [1, 1] and np.isfinite(multi.poses.numpy()).all()
plain, plain_counts = batch.process_sessions_multipass(cfg, lane_passes, run_dpg=False, device="cpu")
from dpg_slam_tpu_torch import scan
assert plain_counts == multi_counts and not ((plain.labels == scan.ADDED) | (plain.labels == scan.REMOVED)).any()
assert not any(m == "jax" or m.startswith(("jax.", "dpg_slam_tpu.")) or m == "dpg_slam_tpu"
               for m in sys.modules if sys.modules[m] is not None)
print("three keyframes", int(eng.state.graph.num_edges), "dpg layers", len(layers["active_static"]),
      "batched lanes", counts, "server lanes", [srv.num_nodes(i) for i in range(2)], "multipass lanes", multi_counts)
"""


def _env(with_repo: bool):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if with_repo:
        env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=_env(True),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "three keyframes" in proc.stdout and "dpg layers" in proc.stdout and "batched lanes" in proc.stdout
    assert "server lanes" in proc.stdout
    assert "multipass lanes" in proc.stdout


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(True),
        capture_output=True, text=True, timeout=300,
    )
    _assert_refused(proc)
    assert "CUDA" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(False),
        capture_output=True, text=True, timeout=300,
    )
    _assert_refused(proc)
