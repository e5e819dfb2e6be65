"""Port parity: dpg_slam_tpu_torch.ops.raster and the helpers of
dpg_slam_tpu_torch.dpg.change_detection against the JAX package, on
seeded inputs at tests/test_dpg.py::dpg_config's size (256 beams, a 256²
grid at 0.1 m).

Tolerances: rasterized grids, _beam_select, _dilate_occupied, the row
gather, occupancy_snapshot and map_layers' masks equal JAX's to the bit;
map-frame points agree within 1e-5 m (cos/sin differ in the last bits).
_polar_free_at's cross-track gate and beam index turn on one-ulp
differences of atan2 between XLA and torch: at most 1e-3 of the compared
entries may differ, and the count is printed. Coverage growth picks JAX's
contributors in JAX's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu import scan as jscan
from dpg_slam_tpu.dpg import change_detection as jcd
from dpg_slam_tpu.engine import DpgSlamEngine as JaxEngine
from dpg_slam_tpu.io import dataset as jds
from dpg_slam_tpu.ops import raster as jraster
from dpg_slam_tpu.utils.checkpoint import _flatten_state
from dpg_slam_tpu_torch import scan as tscan
from dpg_slam_tpu_torch.config import DpgConfig as TorchConfig
from dpg_slam_tpu_torch.dpg import change_detection as tcd
from dpg_slam_tpu_torch.engine import DpgSlamEngine
from dpg_slam_tpu_torch.ops import raster as traster
from dpg_slam_tpu_torch.utils.checkpoint import state_from_numpy

from test_dpg import _coverage_cfg, _coverage_scene_state, dpg_config

POLAR_MISMATCH_FRAC = 1e-3


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _tcfg(jcfg):
    return TorchConfig.from_json(jcfg.to_json())


def _to_port(jcfg, jstate):
    return state_from_numpy({k: np.asarray(v) for k, v in _flatten_state(jstate).items()}, _tcfg(jcfg), "cpu")


def _scan_case(seed, G=3, B=64):
    rng = np.random.default_rng(seed)
    laser = rng.uniform(-1, 1, (G, 3)).astype(np.float32)
    pts = rng.uniform(-4, 4, (G, B, 2)).astype(np.float32)
    ranges = rng.uniform(0.5, 4, (G, B)).astype(np.float32)
    occ = rng.random((G, B)) > 0.3
    free = rng.random((G, B)) > 0.2
    return laser, pts, ranges, occ, free


# --- ops/raster.py ------------------------------------------------------------

def test_world_to_cell_quantization():
    pts = np.array([[0.0, 0.0], [0.26, -0.26], [0.05, -0.15], [0.25, 0.35]], np.float32)
    origin = np.array([-1.0, -1.0], np.float32)
    got = traster.world_to_cell(_t(pts), _t(origin), 0.1).numpy()
    np.testing.assert_array_equal(got[:2], [[10, 10], [13, 7]])
    np.testing.assert_array_equal(got, np.asarray(jraster.world_to_cell(jnp.asarray(pts), jnp.asarray(origin), 0.1)))
    rng = np.random.default_rng(5)
    q = rng.uniform(-20, 20, (4000, 2)).astype(np.float32)
    o = np.array([-12.8, -6.4], np.float32)
    cells = traster.world_to_cell(_t(q), _t(o), 0.05)
    want = np.asarray(jraster.world_to_cell(jnp.asarray(q), jnp.asarray(o), 0.05))
    np.testing.assert_array_equal(cells.numpy(), want)
    np.testing.assert_array_equal(traster.in_window(cells, 256).numpy(), np.asarray(jraster.in_window(jnp.asarray(want), 256)))


def test_rasterize_single_beam():
    """One beam: endpoint cell OCCUPIED, ray cells FREE, elsewhere UNKNOWN."""
    ones = torch.ones((1, 1), dtype=torch.bool)
    g = traster.rasterize_scans(
        torch.zeros((1, 3)), torch.tensor([[[2.0, 0.0]]]), torch.tensor([[2.0]]), ones, ones,
        torch.tensor([-3.2, -3.2]), 64, 0.1, 40,
    )[0].numpy()
    assert g[52, 32] == traster.OCCUPIED and g[40, 32] == traster.FREE and g[32, 40] == traster.UNKNOWN
    assert (g == traster.OCCUPIED).sum() == 1
    assert g.dtype == np.int8 and g.shape == (64, 64)


def test_rasterize_occupied_wins_over_free():
    ones = torch.ones((1, 2), dtype=torch.bool)
    g = traster.rasterize_scans(
        torch.zeros((1, 3)), torch.tensor([[[1.0, 0.0], [2.0, 0.0]]]), torch.tensor([[1.0, 2.0]]), ones, ones,
        torch.tensor([-3.2, -3.2]), 64, 0.1, 40,
    )[0].numpy()
    assert g[42, 32] == traster.OCCUPIED


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_scans_matches_jax(seed):
    laser, pts, ranges, occ, free = _scan_case(seed)
    origin = np.array([-3.2, -3.1], np.float32)
    want = np.asarray(jraster.rasterize_scans(*map(jnp.asarray, (laser, pts, ranges, occ, free, origin)), 64, 0.1, 40))
    got = traster.rasterize_scans(_t(laser), _t(pts), _t(ranges), _t(occ, torch.bool), _t(free, torch.bool),
                                  _t(origin), 64, 0.1, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1).sum() > 100 and (want == 2).sum() > 50  # both layers exercised, some writes dropped
    endp = traster.rasterize_endpoints(_t(pts), _t(occ, torch.bool), _t(origin), 64, 0.1)
    want = jraster.rasterize_endpoints(jnp.asarray(pts), jnp.asarray(occ), jnp.asarray(origin), 64, 0.1)
    np.testing.assert_array_equal(endp.numpy(), np.asarray(want))


def test_rasterize_endpoints_matches_scans_occupied_layer():
    laser, pts, ranges, occ, _ = _scan_case(1)
    origin = torch.tensor([-3.2, -3.2])
    full = traster.rasterize_scans(_t(laser), _t(pts), _t(ranges), _t(occ, torch.bool),
                                   torch.zeros(occ.shape, dtype=torch.bool), origin, 64, 0.1, 40)
    endp = traster.rasterize_endpoints(_t(pts), _t(occ, torch.bool), origin, 64, 0.1)
    np.testing.assert_array_equal((endp == 2).numpy(), (full == 2).numpy())
    assert not (endp == 1).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_rasterize_per_grid_origins(seed):
    """(G, 1, 2) origins, one window per grid (the lane form's layout),
    equal G one-grid calls at each grid's own (2,) origin to the bit."""
    laser, pts, ranges, occ, free = _scan_case(seed)
    origins = np.random.default_rng(seed).uniform(-4.0, -2.5, (laser.shape[0], 2)).astype(np.float32)
    args = (_t(laser), _t(pts), _t(ranges), _t(occ, torch.bool), _t(free, torch.bool))
    grids = traster.rasterize_scans(*args, _t(origins[:, None]), 64, 0.1, 40)
    endp = traster.rasterize_endpoints(args[1], args[3], _t(origins[:, None]), 64, 0.1)
    assert grids.shape == endp.shape == (laser.shape[0], 64, 64)
    for g in range(laser.shape[0]):
        one = [a[g:g + 1] for a in args]
        assert torch.equal(grids[g], traster.rasterize_scans(*one, _t(origins[g]), 64, 0.1, 40)[0])
        assert torch.equal(endp[g], traster.rasterize_endpoints(one[1], one[3], _t(origins[g]), 64, 0.1)[0])
        assert (grids[g] == traster.OCCUPIED).any() and (grids[g] == traster.FREE).any()


# --- change_detection helpers -------------------------------------------------

def test_beam_select_and_dilate_match_jax():
    jcfg = dpg_config()
    tcfg = _tcfg(jcfg)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 5, (6, 256)).astype(np.int8)
    sectors = rng.random((6, 5)) > 0.3
    want = jcd._beam_select(jcfg, jnp.asarray(labels), jnp.asarray(sectors))
    got = tcd._beam_select(tcfg, torch.as_tensor(labels), torch.as_tensor(sectors))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    grid = (rng.random((3, 64, 48)) > 0.97).astype(np.int8) * 2 + (rng.random((3, 64, 48)) > 0.5).astype(np.int8)
    grid = np.minimum(grid, 2).astype(np.int8)
    for margin in (0, 1, 2):
        for g in (grid, grid[0]):  # a stack of grids and one grid
            want = np.asarray(jcd._dilate_occupied(jnp.asarray(g), margin))
            np.testing.assert_array_equal(tcd._dilate_occupied(torch.as_tensor(g), margin).numpy(), want)


def test_gather_matches_jax_gather_rows():
    """torch.gather stands for the JAX package's one-hot _gather_rows."""
    rng = np.random.default_rng(0)
    for B in (256, 1024, 100):
        table = rng.normal(0, 5, (7, B)).astype(np.float32)
        idx = rng.integers(0, B, (7, 333)).astype(np.int32)
        want = np.asarray(jcd._gather_rows(jnp.asarray(table), jnp.asarray(idx)))
        got = torch.gather(torch.as_tensor(table), 1, torch.as_tensor(idx).long())
        np.testing.assert_array_equal(got.numpy(), want)


def _polar_case(seed, G=4, Q=6000):
    jcfg = dpg_config()
    B = jcfg.scan.num_beams
    rng = np.random.default_rng(seed)
    lidar = np.concatenate([rng.uniform(-1, 1, (G, 2)), rng.uniform(-np.pi, np.pi, (G, 1))], 1).astype(np.float32)
    ranges = rng.uniform(1.0, 8.0, (G, B)).astype(np.float32)
    mask = rng.random((G, B)) > 0.2
    pts = rng.uniform(-8, 8, (Q, 2)).astype(np.float32)
    return jcfg, lidar, ranges, mask, pts


@pytest.mark.parametrize("seed", [0, 1])
def test_polar_free_matches_jax(seed):
    jcfg, lidar, ranges, mask, pts = _polar_case(seed)
    res = jcfg.dpg.occ_grid_resolution
    for slack in (res, -res):
        want = np.asarray(jcd._polar_free_at(jcfg, *map(jnp.asarray, (lidar, ranges, mask, pts)), slack))
        got = tcd._polar_free_at(_tcfg(jcfg), _t(lidar), _t(ranges), _t(mask, torch.bool), _t(pts), slack).numpy()
        differ = int((got != want).sum())
        print(f"polar seed {seed} slack {slack}: {differ} of {want.size} entries differ, {int(want.sum())} free")
        assert want.sum() > 1000
        assert differ <= POLAR_MISMATCH_FRAC * want.size, f"{differ} of {want.size} differ"


def test_polar_free_matches_marched_grid():
    """The polar verdict at a point matches the marched FREE grid at its
    cell, away from quantization boundaries (test_dpg.py's bar)."""
    tcfg = _tcfg(dpg_config())
    B = tcfg.scan.num_beams
    res = tcfg.dpg.occ_grid_resolution
    rng = np.random.default_rng(2)
    ranges = _t(rng.uniform(3.0, 8.0, (1, B)))
    laser = torch.zeros((1, 3))
    ones = torch.ones((1, B), dtype=torch.bool)
    origin = torch.tensor([-12.8, -12.8])
    marched = traster.rasterize_scans(laser, tscan.points_in_laser_frame(ranges, tcfg.scan), ranges, ones, ones,
                                      origin, 256, res, 100)[0].numpy()
    q = _t(rng.uniform(-6, 6, (4000, 2)))
    qc = torch.round(q / res) * res
    free = tcd._polar_free_at(tcfg, laser, ranges, ones, q, res)[0].numpy()
    cells = traster.world_to_cell(qc, origin, res).numpy()
    inw = (cells >= 0).all(1) & (cells < 256).all(1)
    grid_free = np.zeros(len(q), bool)
    grid_free[inw] = marched[cells[inw, 0], cells[inw, 1]] == 1
    rel = qc.numpy()
    r = np.linalg.norm(rel, axis=1)
    ang = np.arctan2(rel[:, 1], rel[:, 0])
    inc = tcfg.scan.angle_increment
    b = np.clip(np.round((ang - tcfg.scan.angle_min) / inc).astype(int), 0, B - 1)
    rg = ranges[0].numpy()[b]
    dphi = ang - (tcfg.scan.angle_min + b * inc)
    boundary = (np.abs(r - rg) < 2 * res) | (np.abs(np.abs(dphi) * r - 0.5 * res) < 0.5 * res)
    sel = inw & ~boundary
    agree = (free[sel] == grid_free[sel]).mean()
    assert agree > 0.97, f"polar vs marched agreement {agree:.3f}"


# --- coverage growth (tests/test_dpg.py's hand-built scene) ---------------------

def _contributors(jcfg, jstate, tstate, tcfg):
    """(JAX's, the port's) (contrib_idx, contrib_valid) of the coverage
    growth on the scene, taken inside execute_dpg (in JAX through a debug
    callback of a fresh trace)."""
    box = {}

    def spy_on(mod, store):
        real = mod._coverage_growth_select

        def spy(*a, **k):
            out = real(*a, **k)
            store(*out)
            return out

        return real, spy

    def jax_store(idx, valid):
        jax.debug.callback(lambda i, v: box.update(jax=(np.asarray(i), np.asarray(v))), idx, valid)

    def torch_store(idx, valid):  # the port's selection is per lane: (1, M) here
        box["torch"] = (idx[0].numpy(), valid[0].numpy())

    for mod, cfg, state, store in ((jcd, jcfg, jstate, jax_store), (tcd, tcfg, tstate, torch_store)):
        real, spy = spy_on(mod, store)
        mod._coverage_growth_select = spy
        try:
            if mod is jcd:
                jcd.execute_dpg.clear_cache()
                jax.block_until_ready(jcd.execute_dpg(cfg, state))
            else:
                tcd.execute_dpg(cfg, state)
        finally:
            mod._coverage_growth_select = real
            jcd.execute_dpg.clear_cache()
    return box["jax"], box["torch"]


@pytest.mark.parametrize("threshold", [1.0, 0.3])
def test_coverage_growth_picks_jax_contributors(threshold):
    jcfg = _coverage_cfg(True)
    jcfg = dataclasses.replace(jcfg, dpg=dataclasses.replace(jcfg.dpg, current_pose_graph_coverage_threshold=threshold))
    tcfg = _tcfg(jcfg)
    jstate = _coverage_scene_state(jcfg)
    (jidx, jvalid), (tidx, tvalid) = _contributors(jcfg, jstate, _to_port(jcfg, jstate), tcfg)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tidx[tvalid], jidx[jvalid])
    assert jvalid.sum() >= 1


def test_coverage_growth_beats_m_nearest():
    covs = {}
    for growth in (False, True):
        jcfg = _coverage_cfg(growth)
        _, info = tcd.execute_dpg(_tcfg(jcfg), _to_port(jcfg, _coverage_scene_state(jcfg)))
        covs[growth] = float(info.coverage)
    assert covs[False] < 0.65, f"M-nearest unexpectedly covered: {covs}"
    assert covs[True] > 0.75, f"coverage growth under-covered: {covs}"
    assert covs[True] > covs[False] + 0.15


def test_coverage_growth_stops_at_threshold():
    jcfg = _coverage_cfg(True)
    jcfg = dataclasses.replace(jcfg, dpg=dataclasses.replace(jcfg.dpg, current_pose_graph_coverage_threshold=0.3))
    _, info = tcd.execute_dpg(_tcfg(jcfg), _to_port(jcfg, _coverage_scene_state(jcfg)))
    assert int(info.num_contributors) < 3
    assert float(info.coverage) >= 0.3


# --- occupancy_snapshot and map_layers ------------------------------------------

@pytest.fixture(scope="module")
def short_run():
    """Both engines over the first waypoints of the office loop (one pass)
    at dpg_config, then one pass-0 node deactivated, a sector cleared and
    labels of every kind written, so every mask of the layers is exercised."""
    jcfg = dpg_config()
    seq = jds.simulate_sequence(jds.make_office_world(), jds.office_loop_waypoints()[:6], jcfg.scan, step=0.5, seed=2)
    je = JaxEngine(jcfg)
    for t in range(len(seq.scans)):
        je.observe_odometry(seq.odometry[t])
        je.observe_laser(seq.scans[t])
    n = je.num_nodes()
    rng = np.random.default_rng(4)
    labels = np.asarray(je.state.labels).copy()
    kinds = rng.choice([jscan.STATIC, jscan.ADDED, jscan.REMOVED, jscan.NOT_YET_LABELED], labels.shape).astype(np.int8)
    labels = np.where(labels == jscan.MAX_RANGE, labels, kinds)
    sectors = np.asarray(je.state.sector_active).copy()
    sectors[1, 2] = False
    active = np.asarray(je.state.node_active).copy()
    active[n - 1] = False
    je.state = je.state._replace(labels=jnp.asarray(labels), sector_active=jnp.asarray(sectors),
                                 node_active=jnp.asarray(active))
    te = DpgSlamEngine(_tcfg(jcfg), "cpu")
    te.state = _to_port(jcfg, je.state)
    return jcfg, je, te


@pytest.mark.parametrize("include_inactive", [False, True])
def test_occupancy_snapshot_matches_jax(short_run, include_inactive, monkeypatch):
    jcfg, je, te = short_run
    want, w_origin = je.occupancy_grid(extent=256, include_inactive=include_inactive)
    got, origin = te.occupancy_grid(extent=256, include_inactive=include_inactive)
    np.testing.assert_array_equal(origin, w_origin)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and got.shape == (256, 256)
    assert (got == 2).sum() > 50 and (got == 1).sum() > 1000
    # A march in chunks of three nodes writes the same grid.
    center = torch.as_tensor(te.state.poses[: te.num_nodes(), :2].numpy().mean(axis=0))
    monkeypatch.setattr(tcd, "_SNAPSHOT_CHUNK_POINTS", 256 * 100 * 3)
    grid, _ = tcd.occupancy_snapshot(te.config, te.state, center, 256, include_inactive)
    np.testing.assert_array_equal(grid.numpy(), want)
    # Occupied cells correspond to map points (test_aux.py's check).
    pts = te.map_points(subsample=1)
    res = jcfg.dpg.occ_grid_resolution
    cells = np.round(pts / res).astype(int) - np.round(origin / res).astype(int)
    inside = (cells >= 0).all(1) & (cells < 256).all(1)
    assert (got[cells[inside, 0], cells[inside, 1]] == 2).mean() > 0.9


def test_map_layers_and_map_points_match_jax(short_run):
    """Layer masks equal JAX's to the bit; point coordinates agree within
    1e-5 m (cos/sin of the beam angles and poses differ in the last bits
    between XLA and torch)."""
    jcfg, je, te = short_run
    want_dev = jcd.map_layers(jcfg, je.state)
    got_dev = tcd.map_layers(te.config, te.state)
    for name, (pts, mask) in want_dev.items():
        np.testing.assert_array_equal(got_dev[name][1].numpy(), np.asarray(mask), err_msg=name)
        np.testing.assert_allclose(got_dev[name][0].numpy(), np.asarray(pts), atol=1e-5, rtol=0, err_msg=name)
    want, got = je.map_layers(), te.map_layers()
    assert set(got) == set(want) == {"active_static", "active_added", "dynamic_added", "dynamic_removed"}
    for name in want:
        assert len(want[name]) > 0 and got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0, err_msg=name)
    for sub in (None, 1, 4):
        np.testing.assert_allclose(te.map_points(sub), je.map_points(sub), atol=1e-5, rtol=0)
    pts = te.map_points()
    assert pts.ndim == 2 and pts.shape[1] == 2 and len(pts) > 50
