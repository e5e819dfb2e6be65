"""The port's DPG on a static world: the office loop driven twice through
the engine (tests/test_dpg.py's dpg_config, DPG on in pass 1) labels
(almost) nothing ADDED or REMOVED. Kept apart from tests/test_torch_dpg.py
so that the two files run on separate workers."""

from dpg_slam_tpu import scan
from dpg_slam_tpu.io import dataset as jds
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.engine import DpgSlamEngine

from test_dpg import dpg_config


def _tcfg(jcfg):
    return TorchConfig.from_json(jcfg.to_json())


def _drive(eng, seq):
    for t in range(len(seq.scans)):
        eng.observe_odometry(seq.odometry[t])
        eng.observe_laser(seq.scans[t])


def test_dpg_static_environment_no_changes():
    """Same world twice -> (almost) nothing labeled ADDED/REMOVED."""
    cfg = _tcfg(dpg_config())
    world = jds.make_office_world()
    wps = jds.office_loop_waypoints()
    eng = DpgSlamEngine(cfg, "cpu")
    _drive(eng, jds.simulate_sequence(world, wps, dpg_config().scan, step=0.5, seed=5))
    eng.increment_pass()
    _drive(eng, jds.simulate_sequence(world, wps, dpg_config().scan, step=0.5, seed=6))
    labels = eng.state.labels[: eng.num_nodes()].numpy()
    total = (labels != scan.MAX_RANGE).sum()
    changed = ((labels == scan.ADDED) | (labels == scan.REMOVED)).sum()
    assert eng.last_dpg_info is not None
    assert changed / total < 0.05, f"{changed}/{total} points changed in a static world"
