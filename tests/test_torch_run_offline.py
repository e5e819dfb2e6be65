"""The port's experiment runner against the JAX package's with --offline
(each pass through process_sequence), on tests/test_torch_run.py's
arguments and bounds; its --save-logs logs replayed through --logs; and
the engine-level cases the runner relies on, on the port: corrupted and
all-max-range scans (tests/test_robustness.py), a mid-session checkpoint
resuming identically (1e-4, as there), and the reference-parity
configuration labelling nothing
(tests/test_aux.py::test_reference_parity_mode_runs), each held against
the JAX package's engine on the same config and scans."""

import numpy as np
import pytest

from dpg_slam_tpu import run as jrun
from dpg_slam_tpu.config import DpgConfig as JaxConfig
from dpg_slam_tpu.engine import DpgSlamEngine as JaxEngine
from dpg_slam_tpu_torch import run, scan
from dpg_slam_tpu_torch.config import CapacityParams, DpgConfig, DpgParams, PoseGraphParams, ScanParams
from dpg_slam_tpu_torch.engine import DpgSlamEngine
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.utils import checkpoint
from test_torch_run import ARGS, ATE_TOL, _one_torch_thread, assert_runner_matches_jax, both_runners  # noqa: F401


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    return both_runners(tmp_path_factory, "offline", ["--offline"], port_extra=["--save-logs"])


def test_runner_matches_jax_offline(offline):
    _, eng, port_out, jax_out = offline
    assert_runner_matches_jax(port_out, jax_out)
    assert eng.last_dpg_info is not None


def test_replay_saved_logs(offline):
    summary, eng, port_out, _ = offline
    logs = [str(port_out / f"pass{p}.dsl") for p in range(2)]
    replay, replay_eng = run.run(run.parse_args([*ARGS, "--offline", "--device", "cpu", "--logs", *logs]))
    assert [p["keyframes"] for p in replay["passes"]] == [p["keyframes"] for p in summary["passes"]]
    np.testing.assert_array_equal(replay_eng.trajectory(), eng.trajectory())
    assert replay["map_layers"] == summary["map_layers"]


def _small_config():
    return DpgConfig(
        scan=ScanParams(num_beams=256, range_max=10.0),
        pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=20, max_loop_closures_per_node=2),
        capacity=CapacityParams(max_nodes=64, max_edges=512, max_priors=8),
    )


@pytest.fixture(scope="module")
def seq():
    return dataset.simulate_sequence(dataset.make_office_world(), dataset.office_loop_waypoints(),
                                     _small_config().scan, step=0.5, seed=9, odom_noise_transl=0.02,
                                     odom_noise_rot=0.008)


def _session(odometry, scans):
    return dataset.Sequence(scans=np.asarray(scans), odometry=np.asarray(odometry), ground_truth=None)


def _both_engines(cfg, sessions):
    """The port's engine and the JAX package's on cfg, each fed the same
    sessions through its runner's run_pass (one pass each, increment_pass
    between); returns (port engine, JAX engine, keyframes per pass of each)."""
    eng, jeng = DpgSlamEngine(cfg, "cpu"), JaxEngine(JaxConfig.from_json(cfg.to_json()))
    kfs, jkfs = [], []
    for p, s in enumerate(sessions):
        if p:
            eng.increment_pass()
            jeng.increment_pass()
        kfs.append(run.run_pass(eng, s))
        jkfs.append(jrun.run_pass(jeng, s))
    return eng, jeng, kfs, jkfs


def _assert_engines_agree(eng, jeng, kfs, jkfs):
    assert kfs == jkfs
    assert eng.num_nodes() == jeng.num_nodes()
    np.testing.assert_allclose(eng.trajectory(), jeng.trajectory(), atol=ATE_TOL)


@pytest.mark.parametrize("case", ["corrupted", "all_max_range"])
def test_bad_scans_do_not_poison_the_session(seq, case):
    cfg = _small_config()
    if case == "corrupted":
        bad = {10: np.full_like(seq.scans[0], np.nan), 11: np.full_like(seq.scans[0], np.inf),
               12: np.zeros_like(seq.scans[0])}
        T = 40
    else:
        empty = np.full_like(seq.scans[0], cfg.scan.range_max)
        bad, T = {6: empty, 7: empty}, 30
    eng, jeng, kfs, jkfs = _both_engines(cfg, [_session(seq.odometry[:T],
                                                        [bad.get(t, seq.scans[t]) for t in range(T)])])
    assert eng.num_nodes() >= (5 if case == "corrupted" else 2)
    assert np.isfinite(eng.trajectory()).all()
    _assert_engines_agree(eng, jeng, kfs, jkfs)


def test_checkpoint_resume_continues_identically(seq, tmp_path):
    """The resumed run equals the port's uninterrupted one (1e-4) and
    agrees with the JAX package's uninterrupted one."""
    cfg = _small_config()
    T, half = len(seq.scans), len(seq.scans) // 2
    ref, jref, kfs, jkfs = _both_engines(cfg, [seq])
    _assert_engines_agree(ref, jref, kfs, jkfs)
    a = DpgSlamEngine(cfg, "cpu")
    run.run_pass(a, _session(seq.odometry[:half], seq.scans[:half]))
    checkpoint.save_checkpoint(tmp_path / "ck", a)
    b = checkpoint.load_checkpoint(tmp_path / "ck", device="cpu")
    run.run_pass(b, _session(seq.odometry[half:T], seq.scans[half:T]))
    assert b.num_nodes() == ref.num_nodes() > 10
    np.testing.assert_allclose(b.trajectory(), ref.trajectory(), atol=1e-4)


def test_reference_parity_mode_labels_nothing():
    """Fixed ICP covariance, no robust kernel and the reference's integer
    bin ratio: every commit needs all bins changed, so nothing is
    labelled. Both passes against the JAX package's engine on the same
    config and scans: equal keyframes and labels, poses within ATE_TOL."""
    cfg = DpgConfig(
        scan=ScanParams(num_beams=256),
        pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=20, max_loop_closures_per_node=3,
                                   use_fixed_icp_covariance=True, robust_delta=None),
        dpg=DpgParams(grid_extent_cells=256, occ_grid_resolution=0.1, max_submap_nodes=8,
                      replicate_int_bin_ratio=True),
        capacity=CapacityParams(max_nodes=64, max_edges=512, max_priors=8),
    )
    s = dataset.simulate_sequence(dataset.make_office_world(), dataset.office_loop_waypoints()[:6], cfg.scan,
                                  step=0.5, seed=3)
    eng, jeng, kfs, jkfs = _both_engines(cfg, [s, s])
    assert len(kfs[0]) >= 5
    assert eng.last_dpg_info is not None
    _assert_engines_agree(eng, jeng, kfs, jkfs)
    n = eng.num_nodes()
    labels = eng.state.labels[:n].numpy()
    np.testing.assert_array_equal(labels, np.asarray(jeng.state.labels[:n]))
    assert int(((labels == scan.ADDED) | (labels == scan.REMOVED)).sum()) == 0
    assert np.isfinite(eng.trajectory()).all()
