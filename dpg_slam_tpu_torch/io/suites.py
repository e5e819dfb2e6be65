"""Named dataset suites — the port's copy of dpg_slam_tpu/io/suites.py,
the dpg_data_runner experiment definitions.

The reference runner hard-codes two multi-session benchmark suites and
plays them bag-by-bag with per-bag playback windows and rates, setting
per-dataset parameters first (src/runner/dpg_data_runner_main.cc:65-128:
setGdcRosParams/setMitRosParams, runOnGdcRosBags with 4 bags at 0.6-1.2x,
runOnMitRosBags with 10 bags at 0.5-1.2x over 240-310 s windows).

Here a suite is data, not code: a list of SessionSpec (each a log file or
a synthetic scenario plus a replay window), with per-suite config
overrides. Replay windows translate the reference's start/duration
seconds via a nominal scan rate; playback *rate* has no wall-clock
meaning for array replay and maps to a stride (process every k-th scan,
same information-rate effect as a faster bag).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.io import logs as log_io
from dpg_slam_tpu_torch.io.dataset import Sequence

__all__ = ["SessionSpec", "Suite", "apply_overrides", "builtin_suites", "load_suite", "load_suite_file", "materialize"]


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One session of a suite (one rosbag analog).

    Exactly one of `log` (path to a .npz/.dsl sequence log) or `scenario`
    (synthetic world recipe name) is set.
    """

    log: str | None = None
    scenario: str | None = "office"
    seed: int = 0
    # Synthetic-world mutations for multi-pass change detection:
    add_boxes: tuple = ()        # ((cx, cy, w, h), ...)
    # Replay window (playRosbag's start/duration args, runner :38-53)
    start_s: float = 0.0
    duration_s: float | None = None
    nominal_rate_hz: float = 10.0
    stride: int = 1              # rate analog: process every k-th scan
    # Trajectory/noise knobs for synthetic sessions
    step: float = 0.25
    odom_noise_transl: float = 0.02
    odom_noise_rot: float = 0.008


@dataclasses.dataclass(frozen=True)
class Suite:
    """A named experiment: sessions plus per-suite config overrides
    (the setGdcRosParams/setMitRosParams analog — overrides are applied
    to ScanParams/PoseGraphParams/DpgParams fields by name).

    scan_overrides exist for recorded-data suites whose sensor geometry
    differs from the config default (e.g. a 181-beam SICK at +-90 deg on
    the MIT B21 vs the 1024-beam Hokuyo-like default)."""

    name: str
    sessions: tuple
    pose_graph_overrides: tuple = ()   # ((field, value), ...)
    dpg_overrides: tuple = ()
    scan_overrides: tuple = ()
    description: str = ""


def builtin_suites() -> dict[str, Suite]:
    """The two reference benchmark suites, re-cut as synthetic analogs
    (the GDC/MIT rosbags are not redistributable; the suite STRUCTURE —
    session count, windows, rates, per-dataset params — is preserved)."""
    # GDC analog: 4 sessions through the same building, one object swap
    # (dpg_data_runner_main.cc:108-111: 4 bags at 0.6-1.2x).
    gdc = Suite(
        name="gdc",
        description="4-session office analog of runOnGdcRosBags (:95-114)",
        sessions=tuple(
            SessionSpec(
                scenario="office",
                seed=100 + p,
                add_boxes=((2.0, 1.5, 1.0, 1.0),) if p == 0 else
                          (((-3.0, 1.5, 1.0, 1.0),) if p == 3 else ()),
                stride=1 if p < 2 else 2,   # later bags replayed faster
            )
            for p in range(4)
        ),
        # setGdcRosParams (dpg_data_runner_main.cc:65-73): GDC laser
        # extrinsics (kGdcLaser* = 0.2, 0, 0; :16-18) and the GDC keyframe
        # angle gate (pi/6, :72).
        pose_graph_overrides=(
            ("laser_x_in_bl_frame", 0.2),
            ("laser_y_in_bl_frame", 0.0),
            ("laser_orientation_rel_bl_frame", 0.0),
            ("min_angle_between_nodes", math.pi / 6.0),
        ),
    )
    # MIT reading-room analog: 10 short sessions, windowed 240-310 s
    # (dpg_data_runner_main.cc:116-128).
    mit = Suite(
        name="mit",
        description="10-session windowed analog of runOnMitRosBags (:116-128)",
        sessions=tuple(
            SessionSpec(
                scenario="reading_room",   # single room, like the MIT data
                seed=200 + p,
                add_boxes=((2.0, 1.2, 0.6, 0.6),) if p % 3 == 0 else (),
                start_s=2.0,
                duration_s=28.0,
                stride=1 + (p % 2),        # 0.5-1.2x rate analog
            )
            for p in range(10)
        ),
        # setMitRosParams (dpg_data_runner_main.cc:83-90): MIT laser
        # extrinsics (kMitLaser* = 0.2, 0, 0 "TODO set this"; :20-22) and
        # the MIT keyframe angle gate (0.3 rad, :89).
        pose_graph_overrides=(
            ("laser_x_in_bl_frame", 0.2),
            ("laser_y_in_bl_frame", 0.0),
            ("laser_orientation_rel_bl_frame", 0.0),
            ("min_angle_between_nodes", 0.3),
        ),
    )
    return {"gdc": gdc, "mit": mit}


def load_suite(name: str) -> Suite:
    """Resolve a suite by builtin name, or load a suite MANIFEST file
    (path ending in .json) that binds converted recorded-data logs into
    a multi-pass experiment — the declarative analog of the reference
    runner's hard-coded bag lists (dpg_data_runner_main.cc:95-128).

    Manifest schema (all override blocks optional)::

        {"name": "b21", "description": "...",
         "sessions": [
             {"log": "pass0.npz", "start_s": 0.0, "duration_s": null,
              "stride": 1, "nominal_rate_hz": 10.0},
             ...],
         "scan_overrides": {"num_beams": 181,
                            "angle_min": -1.5708, "angle_max": 1.5708},
         "pose_graph_overrides": {"laser_x_in_bl_frame": 0.0},
         "dpg_overrides": {}}

    Relative log paths resolve against the manifest's directory. Session
    order defines pass order (one session = one pass).
    """
    if str(name).endswith(".json"):
        return load_suite_file(name)
    suites = builtin_suites()
    if name not in suites:
        raise KeyError(
            f"unknown suite {name!r}; have {sorted(suites)} "
            "(or pass a path to a .json suite manifest)"
        )
    return suites[name]


def load_suite_file(path: str | pathlib.Path) -> Suite:
    """Load a recorded-data suite manifest (see load_suite docstring)."""
    path = pathlib.Path(path)
    spec = json.loads(path.read_text())
    sessions = []
    for s in spec.get("sessions", []):
        if "log" not in s:
            raise ValueError(f"{path}: every manifest session needs a 'log'")
        log = pathlib.Path(s["log"])
        if not log.is_absolute():
            log = path.parent / log
        kwargs = {
            k: s[k]
            for k in ("start_s", "duration_s", "stride", "nominal_rate_hz", "seed")
            if k in s
        }
        sessions.append(SessionSpec(log=str(log), scenario=None, **kwargs))
    if not sessions:
        raise ValueError(f"{path}: manifest has no sessions")

    def items(block):
        return tuple(spec.get(block, {}).items())

    return Suite(
        name=spec.get("name", path.stem),
        description=spec.get("description", f"manifest suite from {path}"),
        sessions=tuple(sessions),
        pose_graph_overrides=items("pose_graph_overrides"),
        dpg_overrides=items("dpg_overrides"),
        scan_overrides=items("scan_overrides"),
    )


def apply_overrides(cfg, suite: Suite):
    """Per-suite parameter overrides onto a DpgConfig (rosparam analog)."""
    pg = dataclasses.replace(cfg.pose_graph, **dict(suite.pose_graph_overrides))
    dpg = dataclasses.replace(cfg.dpg, **dict(suite.dpg_overrides))
    sc = dataclasses.replace(cfg.scan, **dict(suite.scan_overrides))
    return dataclasses.replace(cfg, pose_graph=pg, dpg=dpg, scan=sc)


def _window(seq: Sequence, spec: SessionSpec) -> Sequence:
    """Apply the replay window + stride (playRosbag start/duration/rate)."""
    n = len(seq.scans)
    i0 = int(spec.start_s * spec.nominal_rate_hz)
    i1 = n if spec.duration_s is None else min(
        n, i0 + int(spec.duration_s * spec.nominal_rate_hz)
    )
    sl = slice(max(0, i0), i1, max(1, spec.stride))
    return Sequence(
        scans=seq.scans[sl],
        odometry=seq.odometry[sl],
        ground_truth=None if seq.ground_truth is None else seq.ground_truth[sl],
    )


def materialize(spec: SessionSpec, scan_params) -> Sequence:
    """SessionSpec -> Sequence: load the log or simulate the scenario,
    then window it."""
    if spec.log is not None:
        return _window(log_io.load_sequence(pathlib.Path(spec.log)), spec)
    if spec.scenario == "office":
        world = dataset.make_office_world()
        wps = dataset.office_loop_waypoints()
    elif spec.scenario == "reading_room":
        world = dataset.make_reading_room_world()
        wps = dataset.reading_room_waypoints()
    else:
        raise ValueError(f"unknown scenario {spec.scenario!r}")
    for box in spec.add_boxes:
        world = world.add_box(*box)
    seq = dataset.simulate_sequence(
        world, wps, scan_params, step=spec.step, seed=spec.seed,
        odom_noise_transl=spec.odom_noise_transl,
        odom_noise_rot=spec.odom_noise_rot,
    )
    return _window(seq, spec)
