"""Recorded-data on-ramp: rosbag-exported streams -> sequence logs.

The port's copy of dpg_slam_tpu/io/convert.py (numpy only): same inputs give
the same arrays and bytes.

The reference validates exclusively on recorded rosbags (GDC 4 bags, MIT
reading-room 10 bags; runner/dpg_data_runner_main.cc:95-128), where
sensor_msgs/LaserScan and nav_msgs/Odometry arrive asynchronously on
their own clocks and `playRosbag` replays them into the node's
callbacks. This module is the equivalent on-ramp for this framework:
it takes recorded scan + odometry *streams* (each with its own
timestamps) and produces the fixed-shape `Sequence` logs
(`.dsl`/`.npz`, io/logs.py) that suites consume.

Supported inputs (no ROS install needed — use `rostopic echo -p` /
`rosbag`-to-CSV exports, or any npz with the same arrays):

  * CSV pair: a scan CSV (column 0 = stamp seconds, remaining columns =
    ranges, one row per LaserScan) + an odometry CSV (stamp, x, y, and
    either theta or quaternion z,w — 4 or 5 columns).
  * A single .npz with arrays `scan_stamps (T,)`, `scans (T, B)`,
    `odom_stamps (M,)`, `odom (M, 3|4)` (3 = x,y,theta; 4 = x,y,qz,qw).

What conversion does (mirrors what the reference's callback pairing
implicitly does, made explicit and testable):

  1. **Time alignment** — for every scan stamp, the odometry pose is
     linearly interpolated between the bracketing odometry samples
     (angle interpolated shortest-way, wrap-safe). Scans outside the
     odometry time span are dropped (the reference's node simply has no
     odom estimate yet and skips laser processing).
  2. **Beam resampling** — ranges are resampled to a fixed target beam
     count by linear interpolation over beam angle, so heterogeneous
     sensors (e.g. the MIT B21's SICK vs the GDC robot's lidar) land in
     one engine geometry. No-return values (<= 0, non-finite, or >
     range_max) are mapped to `range_max` *before* interpolation and
     re-clamped after, so invalid beams never bleed range into valid
     neighbours (same no-hit convention as io/dataset.py raycasts).
  3. **Stride/window** — optional [t0, t1] clipping and take-every-k,
     the `playRosbag(rate, start, duration)` analog; suites can also do
     this later via SessionSpec.window/stride.

Laser extrinsics (kLaser*InBLFrame, parameters.h) remain a config knob
applied at scan-unpack time, not baked into the log — same division of
labor as the reference (bags store raw sensor data; params hold the
mount).
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from dpg_slam_tpu_torch.io.dataset import Sequence
from dpg_slam_tpu_torch.io import logs as log_io

__all__ = [
    "StreamBundle",
    "load_bag_streams",
    "load_csv_streams",
    "load_npz_streams",
    "align_streams",
    "convert",
    "main",
]


class StreamBundle:
    """Raw asynchronous recorded streams (pre-alignment)."""

    def __init__(
        self,
        scan_stamps: np.ndarray,   # (T,) seconds
        scans: np.ndarray,         # (T, B) ranges
        odom_stamps: np.ndarray,   # (M,) seconds
        odom: np.ndarray,          # (M, 3) x, y, theta
        gt_stamps: np.ndarray | None = None,
        gt: np.ndarray | None = None,
    ):
        self.scan_stamps = np.asarray(scan_stamps, np.float64)
        self.scans = np.asarray(scans, np.float32)
        self.odom_stamps = np.asarray(odom_stamps, np.float64)
        self.odom = np.asarray(odom, np.float64)
        self.gt_stamps = None if gt_stamps is None else np.asarray(gt_stamps, np.float64)
        self.gt = None if gt is None else np.asarray(gt, np.float64)
        if self.scans.ndim != 2 or len(self.scan_stamps) != len(self.scans):
            raise ValueError("scans must be (T, B) with matching scan_stamps")
        if self.odom.shape[1] != 3 or len(self.odom_stamps) != len(self.odom):
            raise ValueError("odom must be (M, 3) with matching odom_stamps")


def _poses_from_columns(cols: np.ndarray) -> np.ndarray:
    """(M, 3|4) -> (M, 3) x, y, theta. 4 columns = x, y, qz, qw
    (planar quaternion, the nav_msgs/Odometry convention)."""
    if cols.shape[1] == 3:
        return cols
    if cols.shape[1] == 4:
        theta = 2.0 * np.arctan2(cols[:, 2], cols[:, 3])
        return np.stack([cols[:, 0], cols[:, 1], theta], axis=1)
    raise ValueError(f"odometry needs 3 or 4 value columns, got {cols.shape[1]}")


def load_csv_streams(
    scan_csv: str | pathlib.Path,
    odom_csv: str | pathlib.Path,
    gt_csv: str | pathlib.Path | None = None,
) -> StreamBundle:
    """CSV exports -> StreamBundle. Column 0 is always the stamp.

    Lines starting with '#' or '%' (rostopic echo -p headers) are
    skipped. Scan CSV: stamp + one column per beam. Odom/GT CSV:
    stamp + (x, y, theta) or (x, y, qz, qw).
    """
    scan_rows = np.loadtxt(scan_csv, delimiter=",", comments=("#", "%"), ndmin=2)
    odom_rows = np.loadtxt(odom_csv, delimiter=",", comments=("#", "%"), ndmin=2)
    gt_stamps = gt_poses = None
    if gt_csv is not None:
        gt_rows = np.loadtxt(gt_csv, delimiter=",", comments=("#", "%"), ndmin=2)
        gt_stamps = gt_rows[:, 0]
        gt_poses = _poses_from_columns(gt_rows[:, 1:])
    return StreamBundle(
        scan_stamps=scan_rows[:, 0],
        scans=scan_rows[:, 1:],
        odom_stamps=odom_rows[:, 0],
        odom=_poses_from_columns(odom_rows[:, 1:]),
        gt_stamps=gt_stamps,
        gt=gt_poses,
    )


def load_npz_streams(path: str | pathlib.Path) -> StreamBundle:
    data = np.load(path)
    gt_stamps = data["gt_stamps"] if "gt_stamps" in data else None
    gt = data["gt"] if "gt" in data else None
    return StreamBundle(
        scan_stamps=data["scan_stamps"],
        scans=data["scans"],
        odom_stamps=data["odom_stamps"],
        odom=_poses_from_columns(np.asarray(data["odom"], np.float64)),
        gt_stamps=gt_stamps,
        gt=None if gt is None else _poses_from_columns(np.asarray(gt, np.float64)),
    )


def load_bag_streams(
    path: str | pathlib.Path,
    scan_topic: str | None = None,
    odom_topic: str | None = None,
    gt_topic: str | None = None,
) -> tuple[StreamBundle, dict]:
    """ROS1 ``.bag`` -> (StreamBundle, scan_meta) via the pure-python
    reader (io/rosbag1.py; no ROS install needed).

    scan_meta carries the recorded sensor geometry (angle_min/max/
    increment, range_min/max, num_beams) so callers can either keep the
    native geometry (num_beams=None in convert) or resample. gt_topic:
    an optional second Odometry stream (mocap / amcl export) recorded as
    ground truth.
    """
    from dpg_slam_tpu_torch.io import rosbag1

    scan_stamps, scans, meta, odom_stamps, odom = rosbag1.read_bag_streams(
        path, scan_topic=scan_topic, odom_topic=odom_topic,
        exclude_topics=() if gt_topic is None else (gt_topic,),
    )
    gt_stamps = gt = None
    if gt_topic is not None:
        _, _, _, gt_stamps, gt = rosbag1.read_bag_streams(
            path, scan_topic=scan_topic, odom_topic=gt_topic
        )
    bundle = StreamBundle(
        scan_stamps=scan_stamps,
        scans=scans,
        odom_stamps=odom_stamps,
        odom=odom,
        gt_stamps=gt_stamps,
        gt=gt,
    )
    return bundle, meta


def _interp_poses(
    query: np.ndarray, stamps: np.ndarray, poses: np.ndarray
) -> np.ndarray:
    """Wrap-safe linear pose interpolation at `query` stamps.

    x/y linear; theta via unwrapped-angle interpolation (shortest-way
    between consecutive samples), then re-wrapped.
    """
    order = np.argsort(stamps, kind="stable")
    stamps = stamps[order]
    poses = poses[order]
    x = np.interp(query, stamps, poses[:, 0])
    y = np.interp(query, stamps, poses[:, 1])
    theta_unwrapped = np.unwrap(poses[:, 2])
    theta = np.interp(query, stamps, theta_unwrapped)
    theta = np.arctan2(np.sin(theta), np.cos(theta))
    return np.stack([x, y, theta], axis=1).astype(np.float32)


def _sanitize_ranges(scans: np.ndarray, range_max: float) -> np.ndarray:
    """Map no-return / invalid readings to range_max (the framework's
    no-hit convention; see io/dataset.py raycaster)."""
    scans = np.asarray(scans, np.float32).copy()
    bad = ~np.isfinite(scans) | (scans <= 0.0) | (scans > range_max)
    scans[bad] = range_max
    return scans


def _resample_beams(scans: np.ndarray, num_beams: int) -> np.ndarray:
    """(T, B) -> (T, num_beams) by linear interpolation over the beam
    index axis (beam angle is affine in index for a constant-increment
    scanner, so index interpolation == angle interpolation)."""
    T, B = scans.shape
    if B == num_beams:
        return scans
    src = np.linspace(0.0, 1.0, B)
    dst = np.linspace(0.0, 1.0, num_beams)
    out = np.empty((T, num_beams), np.float32)
    for t in range(T):
        out[t] = np.interp(dst, src, scans[t])
    return out


def align_streams(
    bundle: StreamBundle,
    num_beams: int,
    range_max: float,
    t_start: float | None = None,
    duration: float | None = None,
    stride: int = 1,
) -> Sequence:
    """Async streams -> fixed-shape Sequence (see module docstring)."""
    stamps = bundle.scan_stamps
    lo = bundle.odom_stamps.min()
    hi = bundle.odom_stamps.max()
    keep = (stamps >= lo) & (stamps <= hi)
    if t_start is not None:
        t0 = stamps[0] + t_start if t_start < 1e6 else t_start  # relative or absolute
        keep &= stamps >= t0
        if duration is not None:
            keep &= stamps <= t0 + duration
    idx = np.nonzero(keep)[0][:: max(1, int(stride))]
    if len(idx) == 0:
        raise ValueError("no scans overlap the odometry time span / window")
    scan_sel = _sanitize_ranges(bundle.scans[idx], range_max)
    scans = np.minimum(_resample_beams(scan_sel, num_beams), range_max)
    odometry = _interp_poses(stamps[idx], bundle.odom_stamps, bundle.odom)
    gt = None
    if bundle.gt is not None and bundle.gt_stamps is not None:
        gt = _interp_poses(stamps[idx], bundle.gt_stamps, bundle.gt)
    return Sequence(scans=scans, odometry=odometry, ground_truth=gt)


def convert(
    scan_src: str | pathlib.Path,
    odom_src: str | pathlib.Path | None,
    out: str | pathlib.Path,
    num_beams: int | None = 1024,
    range_max: float | None = 10.0,
    gt_src: str | pathlib.Path | None = None,
    t_start: float | None = None,
    duration: float | None = None,
    stride: int = 1,
    scan_topic: str | None = None,
    odom_topic: str | None = None,
    gt_topic: str | None = None,
) -> Sequence:
    """One recorded session -> one `.dsl`/`.npz` log. Returns the
    Sequence written (handy for tests).

    Input forms:
      * ``.bag`` — a ROS1 v2.0 bag (pure-python reader, io/rosbag1.py);
        topics default to the bag's single LaserScan/Odometry streams,
        gt_topic optionally names a second Odometry stream recorded as
        ground truth. num_beams/range_max default (None) to the RECORDED
        sensor geometry — the suite manifest's scan_overrides then carry
        that geometry into the engine config.
      * ``.npz`` streams / CSV pair — pre-exported streams (see module
        docstring); num_beams/range_max=None are invalid here (no
        recorded metadata to fall back on).
    """
    scan_src = pathlib.Path(scan_src)
    if scan_src.suffix == ".bag":
        bundle, meta = load_bag_streams(
            scan_src, scan_topic=scan_topic, odom_topic=odom_topic,
            gt_topic=gt_topic,
        )
        if num_beams is None:
            num_beams = meta["num_beams"]
        if range_max is None:
            range_max = meta["range_max"]
    elif scan_src.suffix == ".npz" and odom_src is None:
        bundle = load_npz_streams(scan_src)
    else:
        if odom_src is None:
            raise ValueError("CSV input needs both a scan CSV and an odometry CSV")
        bundle = load_csv_streams(scan_src, odom_src, gt_src)
    if num_beams is None or range_max is None:
        raise ValueError(
            "num_beams/range_max=None (keep recorded geometry) is only "
            "valid for .bag input"
        )
    seq = align_streams(
        bundle,
        num_beams=num_beams,
        range_max=range_max,
        t_start=t_start,
        duration=duration,
        stride=stride,
    )
    log_io.save_sequence(out, seq)
    return seq


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Convert recorded scan/odometry streams to a sequence log"
    )
    p.add_argument(
        "scan",
        help="a ROS1 .bag, a scan CSV (stamp,ranges...), or a streams .npz",
    )
    p.add_argument("out", help="output log path (.dsl or .npz)")
    p.add_argument("--odom", help="odometry CSV (stamp,x,y,theta|qz,qw)")
    p.add_argument("--gt", help="ground-truth CSV (same columns as --odom)")
    p.add_argument(
        "--beams", type=int, default=None,
        help="target beam count (default: recorded geometry for .bag, "
        "1024 otherwise)",
    )
    p.add_argument(
        "--range-max", type=float, default=None,
        help="range_max (default: recorded for .bag, 10.0 otherwise)",
    )
    p.add_argument("--start", type=float, help="window start (s, relative or absolute)")
    p.add_argument("--duration", type=float, help="window length (s)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--scan-topic", help=".bag only: LaserScan topic")
    p.add_argument("--odom-topic", help=".bag only: Odometry topic")
    p.add_argument("--gt-topic", help=".bag only: ground-truth Odometry topic")
    args = p.parse_args(argv)
    is_bag = pathlib.Path(args.scan).suffix == ".bag"
    seq = convert(
        args.scan,
        args.odom,
        args.out,
        num_beams=args.beams if (args.beams or is_bag) else 1024,
        range_max=args.range_max if (args.range_max or is_bag) else 10.0,
        gt_src=args.gt,
        t_start=args.start,
        duration=args.duration,
        stride=args.stride,
        scan_topic=args.scan_topic,
        odom_topic=args.odom_topic,
        gt_topic=args.gt_topic,
    )
    print(
        f"wrote {args.out}: {seq.scans.shape[0]} timesteps x "
        f"{seq.scans.shape[1]} beams"
        + ("" if seq.ground_truth is None else " (+ground truth)")
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
