"""The benchmark's frozen simulator gives the port's sequences."""

import numpy as np
import pytest

from dpg_slam_tpu_torch.config import ScanParams
from dpg_slam_tpu_torch.io import dataset
from slambench import sim


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_sessions_equal_port_simulator(seed):
    sp = ScanParams(num_beams=256)
    geom = sim.ScanGeometry(sp.num_beams, sp.angle_min, sp.angle_max, sp.range_min, sp.range_max)
    world = dataset.make_office_world().add_box(2.0, 1.5, 1.0, 1.0)
    wps = dataset.office_loop_waypoints()
    want = dataset.simulate_sequence(world, wps, sp, step=0.25, seed=seed, odom_noise_transl=0.02,
                                     odom_noise_rot=0.008)
    got = sim.simulate_sessions(sim.office_world([(2.0, 1.5, 1.0, 1.0)]), sim.office_loop_waypoints(1), geom,
                                [seed + 1, seed], odom_noise_transl=0.02, odom_noise_rot=0.008)[1]
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_office_world_and_loop_equal_port():
    assert np.array_equal(sim.office_world(), dataset.make_office_world().segments)
    wps = dataset.office_loop_waypoints()
    assert np.array_equal(sim.office_loop_waypoints(3), np.vstack([wps, wps[1:], wps[1:]]))
