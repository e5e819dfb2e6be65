"""The port's dataset layer (dpg_slam_tpu_torch/io) against the JAX
package's on the same seeded inputs: the reading-room world, sequence
logs (.npz / .dsl, native and pure-Python readers, each package reading
the other's files), the gdc / mit suites and manifests, ROS1 bags (bytes
written, bags read both ways, the hand-assembled golden bags of
tests/test_rosbag_golden.py) and stream conversion. Every comparison is
to the bit: these modules are numpy on both sides."""

import bz2
import dataclasses
import json
import pathlib
import struct

import numpy as np
import pytest

import test_rosbag_golden as golden
from dpg_slam_tpu.config import DpgConfig as JDpgConfig
from dpg_slam_tpu.config import ScanParams as JScanParams
from dpg_slam_tpu.io import convert as jconvert
from dpg_slam_tpu.io import dataset as jdataset
from dpg_slam_tpu.io import logs as jlogs
from dpg_slam_tpu.io import rosbag1 as jrosbag1
from dpg_slam_tpu.io import suites as jsuites
from dpg_slam_tpu_torch.config import DpgConfig, ScanParams
from dpg_slam_tpu_torch.io import convert, dataset, logs, rosbag1, suites

FIXTURE = pathlib.Path(__file__).resolve().parent.parent / "datasets" / "b21_analog"
SCAN = dict(num_beams=128, range_max=10.0)


def _same_seq(a, b):
    for x, y in zip(a, b, strict=True):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def seq():
    return dataset.simulate_sequence(dataset.make_office_world(), dataset.office_loop_waypoints()[:5],
                                     ScanParams(**SCAN), step=0.5, seed=2)


# --- dataset -------------------------------------------------------------------

def test_reading_room_world_equals_jax():
    w, jw = dataset.make_reading_room_world(), jdataset.make_reading_room_world()
    np.testing.assert_array_equal(w.segments, jw.segments)
    np.testing.assert_array_equal(dataset.reading_room_waypoints(), jdataset.reading_room_waypoints())
    np.testing.assert_array_equal(w.add_box(1, 2, 0.5, 0.5).remove_last_box().segments,
                                  jw.add_box(1, 2, 0.5, 0.5).remove_last_box().segments)
    kw = dict(step=0.5, seed=6, odom_noise_transl=0.02, odom_noise_rot=0.008)
    _same_seq(dataset.simulate_sequence(w, dataset.reading_room_waypoints(), ScanParams(**SCAN), **kw),
              jdataset.simulate_sequence(jw, jdataset.reading_room_waypoints(), JScanParams(**SCAN), **kw))


# --- logs ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npz", "dsl"])
def test_sequence_roundtrip(tmp_path, seq, fmt):
    p = tmp_path / f"seq.{fmt}"
    logs.save_sequence(p, seq)
    _same_seq(logs.load_sequence(p), seq)
    no_gt = seq._replace(ground_truth=None)
    logs.save_sequence(tmp_path / "nogt.dsl", no_gt)
    _same_seq(logs.load_sequence(tmp_path / "nogt.dsl"), no_gt)


@pytest.mark.parametrize("fmt", ["npz", "dsl"])
def test_logs_cross_read_with_jax(tmp_path, seq, fmt):
    """A log the port writes, the JAX package reads, and the other way."""
    logs.save_sequence(tmp_path / f"port.{fmt}", seq)
    jlogs.save_sequence(tmp_path / f"jax.{fmt}", seq)
    _same_seq(jlogs.load_sequence(tmp_path / f"port.{fmt}"), seq)
    _same_seq(logs.load_sequence(tmp_path / f"jax.{fmt}"), seq)
    if fmt == "dsl":
        assert (tmp_path / "port.dsl").read_bytes() == (tmp_path / "jax.dsl").read_bytes()


def test_python_dsl_equals_native(tmp_path, seq):
    if logs.native_lib() is None:
        pytest.skip("native library not built")
    assert logs.dsl_reader() == "native"
    logs.save_sequence(tmp_path / "native.dsl", seq)
    logs._save_dsl_python(tmp_path / "python.dsl", seq.scans, seq.odometry, seq.ground_truth, True)
    assert (tmp_path / "native.dsl").read_bytes() == (tmp_path / "python.dsl").read_bytes()
    _same_seq(logs._load_dsl_python(tmp_path / "native.dsl"), logs.load_sequence(tmp_path / "native.dsl"))


@pytest.mark.parametrize("reader", ["load_sequence", "python"])
@pytest.mark.parametrize("content", [b"not a log file at all....", b"DPL", struct.pack("<IIII", 0x44504C31, 4, 8, 1)])
def test_dsl_rejects_garbage(tmp_path, reader, content):
    p = tmp_path / "bad.dsl"
    p.write_bytes(content)
    with pytest.raises(IOError):
        (logs.load_sequence if reader == "load_sequence" else logs._load_dsl_python)(p)
    with pytest.raises(ValueError):
        logs.load_sequence(tmp_path / "seq.txt")


# --- suites --------------------------------------------------------------------

def test_builtin_suites_equal_jax():
    port, jax_ = suites.builtin_suites(), jsuites.builtin_suites()
    assert sorted(port) == sorted(jax_) == ["gdc", "mit"]
    for name in port:
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(jax_[name])
    assert len(port["gdc"].sessions) == 4 and len(port["mit"].sessions) == 10
    with pytest.raises(KeyError):
        suites.load_suite("nope")


@pytest.mark.parametrize("name", ["gdc", "mit", str(FIXTURE / "suite.json")])
def test_apply_overrides_equals_jax(name):
    got = suites.apply_overrides(DpgConfig(scan=ScanParams(**SCAN)), suites.load_suite(name))
    want = jsuites.apply_overrides(JDpgConfig(scan=JScanParams(**SCAN)), jsuites.load_suite(name))
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("case", ["gdc_window_stride", "gdc_pass3", "mit_pass1", "b21_pass1"])
def test_materialize_equals_jax(case):
    if case == "gdc_window_stride":
        kw = dict(scenario="office", seed=1, start_s=2.0, duration_s=5.0, nominal_rate_hz=10.0, stride=2, step=0.25)
        spec, jspec = suites.SessionSpec(**kw), jsuites.SessionSpec(**kw)
        scan, jscan = ScanParams(**SCAN), JScanParams(**SCAN)
    else:
        name, i = {"gdc_pass3": ("gdc", 3), "mit_pass1": ("mit", 1), "b21_pass1": (str(FIXTURE / "suite.json"), 1)}[case]
        suite, jsuite = suites.load_suite(name), jsuites.load_suite(name)
        spec, jspec = suite.sessions[i], jsuite.sessions[i]
        scan = suites.apply_overrides(DpgConfig(scan=ScanParams(**SCAN)), suite).scan
        jscan = jsuites.apply_overrides(JDpgConfig(scan=JScanParams(**SCAN)), jsuite).scan
    got, want = suites.materialize(spec, scan), jsuites.materialize(jspec, jscan)
    assert len(got.scans) > 5
    _same_seq(got, want)


def test_manifest_errors(tmp_path):
    (tmp_path / "empty.json").write_text('{"sessions": []}')
    with pytest.raises(ValueError, match="no sessions"):
        suites.load_suite(str(tmp_path / "empty.json"))
    (tmp_path / "nolog.json").write_text('{"sessions": [{"stride": 2}]}')
    with pytest.raises(ValueError, match="needs a 'log'"):
        suites.load_suite(str(tmp_path / "nolog.json"))


# --- rosbag1 -------------------------------------------------------------------

def _streams(T=12, B=64, seed=0):
    rng = np.random.default_rng(seed)
    scan_stamps = np.sort(100.0 + np.arange(T) * 0.1 + rng.normal(0, 0.005, T))
    scans = rng.uniform(0.5, 7.5, (T, B)).astype(np.float32)
    odom_stamps = 100.0 + np.arange(2 * T) * 0.05
    odom = np.stack([np.linspace(0, 2, 2 * T), np.linspace(0, 1, 2 * T), np.linspace(-0.5, 2.8, 2 * T)], axis=1)
    return scan_stamps, scans, odom_stamps, odom


def _write(mod, path, compression, gt=False):
    s_st, s, o_st, o = _streams()
    extra = dict(gt_stamps=o_st, gt=o + 0.25) if gt else {}
    mod.write_bag(path, s_st, s, o_st, o, angle_min=-1.5, angle_max=1.5, range_max=8.0,
                  compression=compression, **extra)


def _same_streams(a, b):
    for x, y in zip(a, b, strict=True):
        if isinstance(x, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("gt", [False, True])
def test_write_bag_bytes_and_cross_read(tmp_path, compression, gt):
    _write(rosbag1, tmp_path / "port.bag", compression, gt)
    _write(jrosbag1, tmp_path / "jax.bag", compression, gt)
    assert (tmp_path / "port.bag").read_bytes() == (tmp_path / "jax.bag").read_bytes()
    kw = dict(odom_topic="/odom") if gt else {}
    # Each package reads the other's bag.
    _same_streams(rosbag1.read_bag_streams(tmp_path / "jax.bag", **kw),
                  jrosbag1.read_bag_streams(tmp_path / "port.bag", **kw))
    if gt:
        with pytest.raises(rosbag1.BagError, match="odometry topic"):
            rosbag1.read_bag_streams(tmp_path / "jax.bag")


def test_malformed_bags_raise(tmp_path):
    p = tmp_path / "bad.bag"
    p.write_bytes(b"#ROSBAG V1.2\n" + b"x" * 64)
    with pytest.raises(rosbag1.BagError, match="not a ROS1 v2.0"):
        rosbag1.read_bag(p)
    _write(rosbag1, tmp_path / "good.bag", "none")
    (tmp_path / "trunc.bag").write_bytes((tmp_path / "good.bag").read_bytes()[:-40])
    with pytest.raises(rosbag1.BagError, match="truncated"):
        rosbag1.read_bag(tmp_path / "trunc.bag")
    with pytest.raises(ValueError, match="lz4"):
        _write(rosbag1, tmp_path / "lz4.bag", "lz4")


def _golden_bag(tmp_path, layout: str) -> pathlib.Path:
    """tests/test_rosbag_golden.py's hand-assembled bags, byte for byte."""
    recs = golden.build_records()
    if layout == "unchunked":
        body = golden.bag_header_record(3, 0) + recs
    elif layout == "lz4":
        chunk = golden.record([(b"op", b"\x05"), (b"compression", b"lz4"),
                               (b"size", struct.pack("<I", len(recs)))], b"\x00" * 16)
        body = golden.bag_header_record(3, 1) + chunk
    else:  # two bz2 chunks split after five records, each with a chunk-info record
        off = 0
        for _ in range(5):
            (hlen,) = struct.unpack_from("<I", recs, off)
            off += 4 + hlen
            (dlen,) = struct.unpack_from("<I", recs, off)
            off += 4 + dlen
        chunks = b""
        for part in (recs[:off], recs[off:]):
            chunks += golden.record([(b"op", b"\x05"), (b"compression", b"bz2"),
                                     (b"size", struct.pack("<I", len(part)))], bz2.compress(part))
            chunks += golden.record([(b"op", b"\x06"), (b"ver", struct.pack("<I", 1)),
                                     (b"chunk_pos", struct.pack("<Q", 0)),
                                     (b"start_time", golden.ros_time(100, 0)),
                                     (b"end_time", golden.ros_time(103, 0)),
                                     (b"count", struct.pack("<I", 2))], struct.pack("<II", 7, 3))
        body = golden.bag_header_record(3, 2) + chunks
    p = tmp_path / f"golden_{layout}.bag"
    p.write_bytes(b"#ROSBAG V2.0\n" + body)
    return p


@pytest.mark.parametrize("layout", ["unchunked", "bz2_chunked"])
def test_golden_bags_decode(tmp_path, layout):
    p = _golden_bag(tmp_path, layout)
    conns, msgs = rosbag1.read_bag(p)
    golden.check_decoded(conns, msgs)
    jconns, jmsgs = jrosbag1.read_bag(p)
    assert conns == jconns and len(msgs) == len(jmsgs)


def test_golden_streams_extraction(tmp_path):
    p = _golden_bag(tmp_path, "unchunked")
    scan_stamps, scans, meta, odom_stamps, odom = rosbag1.read_bag_streams(p)
    assert scans.shape == (2, 8)  # the 3-beam partial scan dropped
    np.testing.assert_array_equal(scans[0], np.asarray(golden.RANGES_A, "<f4"))
    np.testing.assert_allclose(scan_stamps, [100.25, 101.5])
    assert meta["num_beams"] == 8 and meta["angle_increment"] == pytest.approx(3.0 / 7)
    np.testing.assert_allclose(odom[:, 0], [1.5, 2.5])
    np.testing.assert_allclose(odom[:, 2], [0.7, -1.2], atol=1e-12)
    _same_streams((scan_stamps, scans, meta, odom_stamps, odom), jrosbag1.read_bag_streams(p))


def test_golden_lz4_chunk_raises(tmp_path):
    with pytest.raises(rosbag1.BagError, match="lz4"):
        rosbag1.read_bag(_golden_bag(tmp_path, "lz4"))


# --- convert -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bag_recorded_geometry", "bag_resampled", "csv", "npz_window"])
def test_convert_equals_jax(tmp_path, seq, case):
    if case.startswith("bag"):
        args = (FIXTURE / "pass0.bag", None)
        kw = dict(odom_topic="/odom", gt_topic="/ground_truth")
        kw |= dict(num_beams=None, range_max=None) if case == "bag_recorded_geometry" else dict(num_beams=128)
    else:
        T = len(seq.scans)
        scan_stamps = 100.0 + 0.1 * np.arange(T)
        odom_stamps = 100.0 - 0.05 + (0.1 / 3.0) * np.arange(3 * T + 4)
        th = np.interp(odom_stamps, scan_stamps, np.unwrap(seq.odometry[:, 2]))
        odom = np.stack([np.interp(odom_stamps, scan_stamps, seq.odometry[:, 0]),
                         np.interp(odom_stamps, scan_stamps, seq.odometry[:, 1]),
                         np.sin(th / 2.0), np.cos(th / 2.0)], axis=1)
        scans = seq.scans.copy()
        scans[3, 5], scans[4, 7], scans[5, 9] = np.nan, np.inf, 0.0
        if case == "csv":
            np.savetxt(tmp_path / "scan.csv", np.column_stack([scan_stamps, scans]), delimiter=",", header="stamp")
            np.savetxt(tmp_path / "odom.csv", np.column_stack([odom_stamps, odom]), delimiter=",")
            np.savetxt(tmp_path / "gt.csv", np.column_stack([scan_stamps, seq.ground_truth]), delimiter=",")
            args = (tmp_path / "scan.csv", tmp_path / "odom.csv")
            kw = dict(num_beams=128, range_max=10.0, gt_src=tmp_path / "gt.csv")
        else:
            np.savez(tmp_path / "streams.npz", scan_stamps=scan_stamps, scans=scans, odom_stamps=odom_stamps,
                     odom=odom)
            args = (tmp_path / "streams.npz", None)
            kw = dict(num_beams=64, range_max=10.0, t_start=0.5, duration=1.0, stride=2)
    got = convert.convert(*args, tmp_path / "port.dsl", **kw)
    want = jconvert.convert(*args, tmp_path / "jax.dsl", **kw)
    assert len(got.scans) > 3
    _same_seq(got, want)
    assert (tmp_path / "port.dsl").read_bytes() == (tmp_path / "jax.dsl").read_bytes()


def test_convert_cli(tmp_path, capsys):
    flags = ["--stride", "2", "--odom-topic", "/odom", "--gt-topic", "/ground_truth"]
    assert convert.main([str(FIXTURE / "pass1.bag"), str(tmp_path / "p1.npz"), *flags]) == 0
    assert "timesteps x 181 beams (+ground truth)" in capsys.readouterr().out
    jconvert.main([str(FIXTURE / "pass1.bag"), str(tmp_path / "j1.npz"), *flags])
    _same_seq(logs.load_sequence(tmp_path / "p1.npz"), jlogs.load_sequence(tmp_path / "j1.npz"))


# --- the recorded fixture through both runners -----------------------------------

def test_b21_fixture_through_both_runners(tmp_path):
    """datasets/b21_analog/suite.json (181 beams, two passes) through
    dpg_slam_tpu_torch.run and dpg_slam_tpu.run, scan by scan (the JAX
    runner's offline mode compiles for ~30 s): keyframes per pass equal, per-pass ATE within 5e-3 m, map-layer counts within
    max(2, 3 %) (tests/test_torch_run.py's bounds); edges within 1 % (the
    port finds 143 against JAX's 142, ROADMAP Queue 3 item 7)."""
    import torch

    from dpg_slam_tpu import run as jrun
    from dpg_slam_tpu_torch import run

    flags = ["--suite", str(FIXTURE / "suite.json")]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port, _ = run.run(run.parse_args([*flags, "--device", "cpu"]))
    finally:
        torch.set_num_threads(n)
    assert jrun.main([*flags, "--out", str(tmp_path)]) == 0
    want = json.loads((tmp_path / "summary.json").read_text())
    assert port["config_beams"] == want["config_beams"] == 181
    assert [p["keyframes"] for p in port["passes"]] == [p["keyframes"] for p in want["passes"]] == [20, 20]
    for p, w in zip(port["passes"], want["passes"]):
        assert abs(p["ate_m"] - w["ate_m"]) <= 5e-3, (p, w)
    for k, v in want["map_layers"].items():
        assert abs(port["map_layers"][k] - v) <= max(2, 0.03 * v), (k, port["map_layers"], v)
    assert abs(port["total_edges"] - want["total_edges"]) <= 0.01 * want["total_edges"]
