"""Port parity: dpg_slam_tpu_torch.engine and utils.checkpoint against the
JAX engine on the simulated office loop at test_engine.small_config().

Tolerances: keyframe indices and the factor graph's edge list must be
identical; poses agree within 1e-3 m / 1e-3 rad after one pass and 2e-3
after the pass-boundary reoptimize (float32 ICP and LM solves in another
summation order; a per-pair ICP difference of ~1e-5 m is propagated
through ~40 keyframes and one full LM solve). State round trips are exact.
"""

import pathlib

import numpy as np
import pytest
import torch

from dpg_slam_tpu import engine as jeng
from dpg_slam_tpu.config import CapacityParams
from dpg_slam_tpu.io import dataset as jds
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu_torch import engine as teng
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.io import dataset as tds
from dpg_slam_tpu_torch.utils import checkpoint as tckpt
from dpg_slam_tpu_torch.utils.metrics import ate_rmse, to_anchor_frame

from test_engine import run_sequence, small_config

ASSETS = pathlib.Path(__file__).parent.parent / "bench_assets"


def _configs():
    # Capacity for two passes of the loop (test_engine's two-pass tests).
    jcfg = small_config().replace(capacity=CapacityParams(max_nodes=128, max_edges=1024, max_priors=8))
    return jcfg, TorchConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def office_seq():
    jcfg, _ = _configs()
    return jds.simulate_sequence(
        jds.make_office_world(), jds.office_loop_waypoints(), jcfg.scan, step=0.5, seed=1,
        odom_noise_transl=0.02, odom_noise_rot=0.008,
    )


@pytest.fixture(scope="module")
def one_pass(office_seq):
    """Both engines after one pass of the loop: (jax_eng, torch_eng, kf_j, kf_t)."""
    jcfg, tcfg = _configs()
    je = jeng.DpgSlamEngine(jcfg)
    te = teng.DpgSlamEngine(tcfg, "cpu")
    return je, te, run_sequence(je, office_seq), run_sequence(te, office_seq)


def _clone(je, te):
    """Fresh engine objects over the same (never mutated in place) states."""
    je2 = jeng.DpgSlamEngine(je.config)
    je2.state = je.state
    te2 = teng.DpgSlamEngine(te.config, "cpu")
    te2.state = te.state
    return je2, te2


def _assert_poses_close(jt, tt, atol):
    np.testing.assert_allclose(tt[:, :2], jt[:, :2], atol=atol)
    dth = np.angle(np.exp(1j * (tt[:, 2].astype(np.float64) - jt[:, 2])))
    np.testing.assert_allclose(dth, 0.0, atol=atol)


def _assert_same_edges(jstate, tstate):
    n = int(jstate.graph.num_edges)
    assert int(tstate.graph.num_edges) == n
    np.testing.assert_array_equal(tstate.graph.edge_idx[:n].numpy(), np.asarray(jstate.graph.edge_idx[:n]))


def test_dataset_copy_matches_jax():
    jcfg, tcfg = _configs()
    kw = dict(step=1.0, seed=3, odom_noise_transl=0.02, odom_noise_rot=0.008)
    a = jds.simulate_sequence(jds.make_office_world(), jds.office_loop_waypoints(), jcfg.scan, **kw)
    b = tds.simulate_sequence(tds.make_office_world(), tds.office_loop_waypoints(), tcfg.scan, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_single_pass_matches_jax(one_pass, office_seq):
    je, te, kf_j, kf_t = one_pass
    assert kf_t == kf_j and len(kf_t) >= 10
    _assert_same_edges(je.state, te.state)
    _assert_poses_close(je.trajectory(), te.trajectory(), 1e-3)
    np.testing.assert_allclose(te.pose(), np.asarray(je.pose()), atol=1e-3)
    # The port tracks on its own terms too (test_engine's ATE bounds).
    gt = to_anchor_frame(office_seq.ground_truth[kf_t])
    ate = ate_rmse(te.trajectory(), gt)
    assert ate < 0.25
    assert ate <= ate_rmse(to_anchor_frame(te.odom_trajectory()), gt) + 0.05


def test_state_round_trip_with_jax_is_exact(one_pass):
    je, _, _, _ = one_pass
    flat = _flatten_state(je.state)
    state = tckpt.state_from_numpy(flat, TorchConfig.from_json(je.config.to_json()), "cpu")
    back = tckpt.state_to_numpy(state)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_load_checkpoint_equals_npz():
    eng = tckpt.load_checkpoint(ASSETS / "keyframe", "cpu")
    with np.load(ASSETS / "keyframe" / "state.npz") as npz:
        stored = dict(npz)
    flat = tckpt.state_to_numpy(eng.state)
    assert flat.keys() == stored.keys()
    for k, v in stored.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert eng.num_nodes() == 25 and eng.config.pose_graph.icp_max_points == 256


def test_state_from_numpy_rejects_wrong_shape():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="poses"):
        tckpt.state_from_numpy({"poses": np.zeros((3, 3), np.float32)}, tcfg, "cpu")


def test_two_pass_reoptimize_matches_jax(one_pass, office_seq):
    je, te, _, _ = one_pass
    je, te = _clone(je, te)
    je._dpg_enabled = False
    te._dpg_enabled = False
    je.increment_pass()
    te.increment_pass()
    _assert_poses_close(je.trajectory(), te.trajectory(), 2e-3)
    assert int(te.state.graph.num_edges) == int(je.state.graph.num_edges)
    # Second pass (every other scan), then the second reoptimize.
    assert run_sequence(te, office_seq, stride=2) == run_sequence(je, office_seq, stride=2)
    je.increment_pass()
    te.increment_pass()
    _assert_poses_close(je.trajectory(), te.trajectory(), 2e-3)
    _assert_same_edges(je.state, te.state)
    assert int(te.state.pass_number) == 2


def test_reoptimize_valid_host_parity(one_pass, office_seq):
    """The numpy validity replica marks exactly the live slots of the
    device enumeration, and equals the JAX package's replica."""
    je, te, _, _ = one_pass
    je, te = _clone(je, te)
    te._dpg_enabled = False
    te.increment_pass()
    run_sequence(te, office_seq, stride=2)
    state = te.state
    cfg = te.config
    dev_valid = teng._reoptimize_pairs(cfg, state)[2].numpy()
    poses, pass_ids = state.poses.numpy(), state.pass_ids.numpy()
    node_mask = np.arange(cfg.capacity.max_nodes) < te.num_nodes()
    host_valid = teng._reoptimize_valid_host(cfg, poses, pass_ids, node_mask)
    np.testing.assert_array_equal(host_valid, dev_valid)
    np.testing.assert_array_equal(host_valid, jeng._reoptimize_valid_host(je.config, poses, pass_ids, node_mask))
    assert dev_valid.sum() > te.num_nodes()  # closures present, not only successive pairs


def test_dpg_on_second_pass_raises(one_pass, office_seq):
    """(Named for the NotImplementedError it once pinned.) The first pass-1
    keyframe runs DPG (on by default) and matches JAX's: the same labels,
    sectors and node activity, and last_dpg_info within 1e-6; map_layers,
    occupancy_grid and map_points return."""
    je, te = _clone(*one_pass[:2])
    je.increment_pass()
    te.increment_pass()
    assert te._dpg_enabled and je._dpg_enabled
    for eng in (je, te):
        eng.observe_odometry(office_seq.odometry[0])
        assert eng.observe_laser(office_seq.scans[0])
    n = je.num_nodes()
    np.testing.assert_array_equal(te.state.labels[:n].numpy(), np.asarray(je.state.labels[:n]))
    np.testing.assert_array_equal(te.state.sector_active[:n].numpy(), np.asarray(je.state.sector_active[:n]))
    np.testing.assert_array_equal(te.state.node_active.numpy(), np.asarray(je.state.node_active))
    for field in te.last_dpg_info._fields:
        np.testing.assert_allclose(float(getattr(te.last_dpg_info, field)), float(getattr(je.last_dpg_info, field)),
                                   atol=1e-6, err_msg=field)
    assert int(te.last_dpg_info.num_contributors) > 0
    want, got = je.map_layers(), te.map_layers()
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
    grid, origin = te.occupancy_grid(extent=256)
    assert grid.shape == (256, 256) and grid.dtype == np.int8 and set(np.unique(grid)) <= {0, 1, 2}
    assert (grid == 2).sum() > 50 and origin.shape == (2,)
    assert te.map_points().shape == je.map_points().shape


def test_relative_odometry_matches_jax(office_seq):
    jcfg, tcfg = _configs()
    je = jeng.DpgSlamEngine(jcfg)
    te = teng.DpgSlamEngine(tcfg, "cpu")
    je.observe_odometry(office_seq.odometry[0])
    te.observe_odometry(office_seq.odometry[0])
    rng = np.random.default_rng(7)
    for _ in range(5):
        delta = rng.normal([0.3, 0.0, 0.1], 0.05).astype(np.float32)
        je.observe_odometry_relative(delta)
        te.observe_odometry_relative(delta)
    np.testing.assert_allclose(te.state.prev_odom.numpy(), np.asarray(je.state.prev_odom), atol=1e-5)
    np.testing.assert_allclose(
        float(te.state.cumulative_dist), float(je.state.cumulative_dist), atol=1e-5
    )


def test_edge_overflow_fails_loudly():
    _, tcfg = _configs()
    eng = teng.DpgSlamEngine(tcfg, "cpu")
    eng._check_edge_overflow(tcfg.capacity.max_edges)  # at capacity: fine
    with pytest.raises(RuntimeError, match="edge capacity"):
        eng._check_edge_overflow(tcfg.capacity.max_edges + 1)


def test_engine_requires_a_device():
    """Entry points run on the card unless the caller names a device; the
    CPU is one argument away."""
    import inspect

    from dpg_slam_tpu_torch.graph import factor_graph as tfg
    from dpg_slam_tpu_torch.parallel import make_mesh

    for fn in (teng.DpgSlamEngine, tckpt.load_checkpoint, tckpt.state_from_numpy, make_mesh, tfg.empty_graph):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    _, tcfg = _configs()
    assert teng.DpgSlamEngine(tcfg, torch.device("cpu")).state.poses.device.type == "cpu"
    assert teng.DpgSlamEngine(tcfg, device="cpu").device.type == "cpu"


def test_engine_config_defaults_like_jax():
    """DpgSlamEngine() takes DpgConfig() when no config is given, as the JAX
    package's engine does."""
    import inspect

    assert inspect.signature(teng.DpgSlamEngine).parameters["config"].default is None
    assert inspect.signature(jeng.DpgSlamEngine).parameters["config"].default is None
    eng = teng.DpgSlamEngine(device="cpu")
    assert eng.config == TorchConfig()
    assert eng.state.poses.device.type == "cpu"
    assert eng.state.poses.shape[0] == TorchConfig().capacity.max_nodes


# --- offline sequence mode (process_sequence) --------------------------------
# At test_engine.small_config() (64 nodes), as tests/test_engine.py's
# offline tests. Tolerances: against the port's online loop,
# tests/test_engine.py's 1e-4 (the same frontend; the solve runs at full
# node capacity instead of the live bucket); against the JAX package's
# offline program, 1e-3, as test_single_pass_matches_jax; the pipelined
# schedule within 0.2 m of the plain one (tests/test_engine.py) and within
# 1e-3 of JAX's pipelined run.


@pytest.fixture(scope="module")
def offline(office_seq):
    """JAX and port engines after process_sequence of one pass, plain and
    pipelined, and the port's online loop over the same scans:
    ({pipelined: (jax_eng, torch_eng, jax_mask, torch_mask)}, (online_eng, keyframes))."""
    jcfg = small_config()
    tcfg = TorchConfig.from_json(jcfg.to_json())
    out = {}
    # One intra-op thread for the port's runs of many tiny ops (OpenMP
    # overhead dominates them when the test workers share the cores).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for pipelined in (False, True):
            je = jeng.DpgSlamEngine(jcfg)
            te = teng.DpgSlamEngine(tcfg, "cpu")
            jm = je.process_sequence(office_seq.odometry, office_seq.scans, pipelined=pipelined)
            tm = te.process_sequence(office_seq.odometry, office_seq.scans, pipelined=pipelined)
            out[pipelined] = (je, te, np.asarray(jm), tm)
        online = teng.DpgSlamEngine(tcfg, "cpu")
        kf_online = run_sequence(online, office_seq)
    finally:
        torch.set_num_threads(threads)
    return out, (online, kf_online)


def test_offline_sequence_matches_online(offline):
    runs, (te_on, kf_on) = offline
    _, te, _, mask = runs[False]
    assert list(np.flatnonzero(mask)) == kf_on
    assert te.num_nodes() == te_on.num_nodes()
    _assert_same_edges(te_on.state, te.state)
    _assert_poses_close(te_on.trajectory(), te.trajectory(), 1e-4)


def test_offline_sequence_matches_jax(offline):
    je, te, jm, tm = offline[0][False]
    assert tm.dtype == bool and tm.shape == jm.shape
    np.testing.assert_array_equal(tm, jm)
    _assert_same_edges(je.state, te.state)
    assert int(te.state.graph.num_priors) == int(je.state.graph.num_priors)
    _assert_poses_close(je.trajectory(), te.trajectory(), 1e-3)


def test_pipelined_sequence_close_to_plain(offline):
    _, te_plain, _, plain_mask = offline[0][False]
    je, te, jm, tm = offline[0][True]
    np.testing.assert_array_equal(tm, plain_mask)
    assert te.num_nodes() == int(tm.sum()) == te_plain.num_nodes()
    d = np.linalg.norm(te.trajectory()[:, :2] - te_plain.trajectory()[:, :2], axis=1)
    assert d.max() < 0.2, f"max pose deviation {d.max()}"
    np.testing.assert_array_equal(tm, jm)
    _assert_same_edges(je.state, te.state)
    _assert_poses_close(je.trajectory(), te.trajectory(), 1e-3)


def test_offline_sequence_respects_capacity(office_seq):
    """At node capacity the offline run drops keyframes with a warning
    instead of raising (the online path raises)."""
    from dpg_slam_tpu_torch.config import CapacityParams as TCap, PoseGraphParams, ScanParams

    cfg = TorchConfig(
        scan=ScanParams(num_beams=256, range_max=10.0),
        pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=10, max_loop_closures_per_node=2),
        capacity=TCap(max_nodes=8, max_edges=64, max_priors=4),
    )
    eng = teng.DpgSlamEngine(cfg, "cpu")
    with pytest.warns(RuntimeWarning, match="capacity"):
        kf_mask = eng.process_sequence(office_seq.odometry, office_seq.scans)
    assert eng.num_nodes() == 8 and kf_mask.sum() == 8
    assert np.isfinite(eng.trajectory()).all()


def test_process_sequence_dpg_raises_before_the_state_changes(offline, office_seq):
    """(Named for the NotImplementedError it once pinned.) On pass 1 with
    DPG on, process_sequence runs a DPG step after each keyframe: the
    online loop's keyframes and labels, and last_dpg_info; a scans array
    of the wrong width still raises ValueError."""
    src = offline[0][False][1]
    s = src.state
    pass1 = s._replace(
        pass_number=torch.ones_like(s.pass_number), odom_initialized=torch.zeros_like(s.odom_initialized),
        first_scan_for_pass=torch.ones_like(s.first_scan_for_pass), cumulative_dist=torch.zeros_like(s.cumulative_dist),
    )
    te = teng.DpgSlamEngine(src.config, "cpu")
    te.state = pass1
    mask = te.process_sequence(office_seq.odometry[:24], office_seq.scans[:24])
    online = teng.DpgSlamEngine(src.config, "cpu")
    online.state = pass1
    kf_online = [t for t in range(24) if (online.observe_odometry(office_seq.odometry[t]) or
                                          online.observe_laser(office_seq.scans[t]))]
    assert list(np.flatnonzero(mask)) == kf_online and len(kf_online) >= 3
    assert te.last_dpg_info is not None and online.last_dpg_info is not None
    assert int(te.last_dpg_info.num_contributors) == int(online.last_dpg_info.num_contributors) > 0
    n = te.num_nodes()
    np.testing.assert_array_equal(te.state.labels[:n].numpy(), online.state.labels[:n].numpy())
    assert src.state is s  # the source engine's state is untouched
    with pytest.raises(ValueError, match="scans"):
        te.process_sequence(office_seq.odometry, office_seq.scans[:, :10], run_dpg=False)
