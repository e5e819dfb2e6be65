"""Minimal pure-python ROS1 ``.bag`` (format v2.0) reader/writer.

The port's copy of dpg_slam_tpu/io/rosbag1.py (numpy only): same inputs give
the same arrays and bytes.

The reference's entire validation basis is rosbag playback
(``rosbag play`` shelled from src/runner/dpg_data_runner_main.cc:38-53,
feeding sensor_msgs/LaserScan + nav_msgs/Odometry into the node's
callbacks). This framework has no ROS runtime, so the on-ramp reads the
bags directly: the ROS1 bag container is a simple public record format
(http://wiki.ros.org/Bags/Format/2.0) and the two message types have
fixed wire layouts, so no ROS install (and no third-party package — the
environment has none) is needed.

Supported container features:
  * record framing: <u32 hlen><header><u32 dlen><data>, header fields
    ``<u32 flen>name=value``;
  * op 0x03 bag header, 0x07 connection, 0x02 message data, 0x05 chunk
    (compression ``none`` and ``bz2``; ``lz4`` raises with guidance since
    the environment has no lz4 binding), 0x04/0x06 index records skipped;
  * connection/message records both at top level and inside chunks
    (rosbag writes chunked; unchunked bags appear from some tools).

Message types decoded (little-endian ROS serialization):
  * ``sensor_msgs/LaserScan`` -> stamp, angle_min/max/increment,
    range_min/max, ranges[] (intensities skipped);
  * ``nav_msgs/Odometry`` -> stamp, x, y, planar yaw from the
    quaternion (full 3D quaternion handled: yaw = atan2-based
    extraction, matching the reference's 2D use of 3D odometry).

Timestamps prefer the message header stamp (sensor clock) and fall back
to the record receive time when the header stamp is zero — the same
ordering ``rosbag play`` reproduces.

The writer emits spec-compliant chunked bags (used for test fixtures
and the committed realistic fixture; also handy to round-trip-verify
the reader against itself).
"""

from __future__ import annotations

import bz2
import pathlib
import struct

import numpy as np

__all__ = [
    "BagError",
    "LaserScanMsg",
    "OdometryMsg",
    "read_bag",
    "read_bag_streams",
    "write_bag",
]

_MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

LASERSCAN_TYPE = "sensor_msgs/LaserScan"
ODOMETRY_TYPE = "nav_msgs/Odometry"


class BagError(ValueError):
    pass


class LaserScanMsg:
    __slots__ = (
        "stamp", "angle_min", "angle_max", "angle_increment",
        "range_min", "range_max", "ranges",
    )

    def __init__(self, stamp, angle_min, angle_max, angle_increment,
                 range_min, range_max, ranges):
        self.stamp = stamp
        self.angle_min = angle_min
        self.angle_max = angle_max
        self.angle_increment = angle_increment
        self.range_min = range_min
        self.range_max = range_max
        self.ranges = ranges


class OdometryMsg:
    __slots__ = ("stamp", "x", "y", "theta")

    def __init__(self, stamp, x, y, theta):
        self.stamp = stamp
        self.x = x
        self.y = y
        self.theta = theta


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise BagError("truncated header field length")
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        if len(field) != flen:
            raise BagError("truncated header field")
        off += flen
        eq = field.find(b"=")
        if eq < 0:
            raise BagError(f"malformed header field {field[:40]!r}")
        fields[field[:eq].decode("ascii")] = field[eq + 1 :]
    return fields


def _iter_records(buf: bytes, off: int = 0):
    n = len(buf)
    while off < n:
        if off + 4 > n:
            raise BagError("truncated record header length")
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        if off + 4 > n:
            raise BagError("truncated record data length")
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        if len(data) != dlen:
            raise BagError("truncated record data")
        off += dlen
        yield header, data


# ---------------------------------------------------------------------------
# Message deserialization (little-endian ROS1 wire format)
# ---------------------------------------------------------------------------

def _read_header_stamp(data: bytes, off: int) -> tuple[float, int]:
    """std_msgs/Header: u32 seq, u32 secs, u32 nsecs, string frame_id."""
    seq_, secs, nsecs = struct.unpack_from("<III", data, off)
    off += 12
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4 + slen
    return secs + nsecs * 1e-9, off


def _decode_laserscan(data: bytes, rec_time: float) -> LaserScanMsg:
    stamp, off = _read_header_stamp(data, 0)
    (a_min, a_max, a_inc, _t_inc, _scan_t, r_min, r_max) = struct.unpack_from(
        "<7f", data, off
    )
    off += 28
    (count,) = struct.unpack_from("<I", data, off)
    off += 4
    ranges = np.frombuffer(data, "<f4", count=count, offset=off).copy()
    return LaserScanMsg(
        stamp=stamp if stamp > 0 else rec_time,
        angle_min=a_min, angle_max=a_max, angle_increment=a_inc,
        range_min=r_min, range_max=r_max, ranges=ranges,
    )


def _decode_odometry(data: bytes, rec_time: float) -> OdometryMsg:
    stamp, off = _read_header_stamp(data, 0)
    (clen,) = struct.unpack_from("<I", data, off)  # child_frame_id
    off += 4 + clen
    x, y, _z, qx, qy, qz, qw = struct.unpack_from("<7d", data, off)
    # yaw extraction valid for arbitrary 3D quaternions (planar use).
    theta = np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return OdometryMsg(stamp=stamp if stamp > 0 else rec_time, x=x, y=y, theta=theta)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _decompress(header: dict, data: bytes) -> bytes:
    comp = header.get("compression", b"none").decode("ascii")
    if comp == "none":
        return data
    if comp == "bz2":
        return bz2.decompress(data)
    raise BagError(
        f"chunk compression {comp!r} not supported (no {comp} binding in "
        "this environment); re-record with 'rosbag compress --bz2' or "
        "export to CSV/npz (io/convert.py)"
    )


def read_bag(path: str | pathlib.Path, topics: set[str] | None = None):
    """Parse a ROS1 v2.0 bag.

    Returns (connections, messages): connections maps conn id ->
    {"topic", "type"}; messages is a list of (topic, type, stamp,
    decoded_or_raw) in file order, where LaserScan/Odometry records are
    decoded and other types carry raw bytes.
    """
    raw = pathlib.Path(path).read_bytes()
    if not raw.startswith(_MAGIC):
        raise BagError(
            f"{path}: not a ROS1 v2.0 bag (magic {raw[:13]!r}); v1.2 bags "
            "must be migrated with 'rosbag fix'"
        )

    connections: dict[int, dict] = {}
    messages: list = []

    def handle(header: dict, data: bytes) -> None:
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONNECTION:
            (conn_id,) = struct.unpack("<I", header["conn"])
            # The connection DATA block is itself header-formatted; its
            # "topic" is the canonical one (the record header's may be a
            # remap alias).
            fields = _parse_header(data)
            topic = fields.get("topic", header.get("topic", b""))
            connections[conn_id] = {
                "topic": topic.decode("utf-8"),
                "type": fields.get("type", b"").decode("utf-8"),
            }
        elif op == _OP_MSG:
            (conn_id,) = struct.unpack("<I", header["conn"])
            secs, nsecs = struct.unpack("<II", header["time"])
            rec_time = secs + nsecs * 1e-9
            conn = connections.get(conn_id)
            if conn is None:
                raise BagError(f"message for unknown connection {conn_id}")
            topic, mtype = conn["topic"], conn["type"]
            if topics is not None and topic not in topics:
                return
            if mtype == LASERSCAN_TYPE:
                messages.append((topic, mtype, _decode_laserscan(data, rec_time)))
            elif mtype == ODOMETRY_TYPE:
                messages.append((topic, mtype, _decode_odometry(data, rec_time)))
            else:
                messages.append((topic, mtype, data))
        elif op == _OP_CHUNK:
            for h, d in _iter_records(_decompress(header, data)):
                handle(h, d)
        # bag header / index / chunk info: skip

    for header, data in _iter_records(raw, len(_MAGIC)):
        handle(header, data)
    return connections, messages


def read_bag_streams(
    path: str | pathlib.Path,
    scan_topic: str | None = None,
    odom_topic: str | None = None,
    exclude_topics: tuple = (),
):
    """Bag -> (scan_stamps, scans(T,B), scan_meta, odom_stamps, odom(M,3)).

    Topic defaults: the single LaserScan topic / the single Odometry
    topic in the bag (error if ambiguous — pass the topic explicitly,
    matching the reference node's /scan and /odom subscriptions,
    dpg_slam_main.cc:310-326). Scans whose beam count differs from the
    first scan's are dropped (partial/corrupt messages).

    scan_meta is {"angle_min", "angle_max", "angle_increment",
    "range_min", "range_max", "num_beams"} from the first scan.
    """
    conns, msgs = read_bag(path)

    def pick(topic, mtype, what):
        if topic is not None:
            return topic
        cands = sorted(
            {c["topic"] for c in conns.values() if c["type"] == mtype}
            - set(exclude_topics)
        )
        if len(cands) != 1:
            raise BagError(
                f"need an explicit {what} topic: bag has {cands or 'none'} "
                f"of type {mtype}"
            )
        return cands[0]

    scan_topic = pick(scan_topic, LASERSCAN_TYPE, "scan")
    odom_topic = pick(odom_topic, ODOMETRY_TYPE, "odometry")

    scans, scan_stamps = [], []
    odom, odom_stamps = [], []
    meta = None
    for topic, mtype, msg in msgs:
        if topic == scan_topic and mtype == LASERSCAN_TYPE:
            if meta is None:
                meta = {
                    "angle_min": float(msg.angle_min),
                    "angle_max": float(msg.angle_max),
                    "angle_increment": float(msg.angle_increment),
                    "range_min": float(msg.range_min),
                    "range_max": float(msg.range_max),
                    "num_beams": int(len(msg.ranges)),
                }
            if len(msg.ranges) != meta["num_beams"]:
                continue
            scans.append(msg.ranges)
            scan_stamps.append(msg.stamp)
        elif topic == odom_topic and mtype == ODOMETRY_TYPE:
            odom.append([msg.x, msg.y, msg.theta])
            odom_stamps.append(msg.stamp)
    if not scans:
        raise BagError(f"no LaserScan messages on topic {scan_topic!r}")
    if not odom:
        raise BagError(f"no Odometry messages on topic {odom_topic!r}")
    return (
        np.asarray(scan_stamps, np.float64),
        np.stack(scans).astype(np.float32),
        meta,
        np.asarray(odom_stamps, np.float64),
        np.asarray(odom, np.float64),
    )


# ---------------------------------------------------------------------------
# Writer (fixtures / round-trip tests)
# ---------------------------------------------------------------------------

def _header_bytes(fields: dict) -> bytes:
    out = b""
    for name, value in fields.items():
        item = name.encode("ascii") + b"=" + value
        out += struct.pack("<I", len(item)) + item
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header_bytes(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time_bytes(stamp: float) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _ser_header(stamp: float, frame_id: bytes = b"laser") -> bytes:
    return (
        struct.pack("<I", 0)
        + _time_bytes(stamp)
        + struct.pack("<I", len(frame_id))
        + frame_id
    )


def _ser_laserscan(stamp, ranges, angle_min, angle_max, angle_increment,
                   range_min, range_max) -> bytes:
    ranges = np.asarray(ranges, "<f4")
    return (
        _ser_header(stamp)
        + struct.pack(
            "<7f", angle_min, angle_max, angle_increment, 0.0, 0.1,
            range_min, range_max,
        )
        + struct.pack("<I", len(ranges))
        + ranges.tobytes()
        + struct.pack("<I", 0)  # empty intensities
    )


def _ser_odometry(stamp, x, y, theta) -> bytes:
    qz, qw = np.sin(theta / 2.0), np.cos(theta / 2.0)
    cov = np.zeros(36, "<f8").tobytes()
    return (
        _ser_header(stamp, b"odom")
        + struct.pack("<I", 9) + b"base_link"
        + struct.pack("<7d", x, y, 0.0, 0.0, 0.0, qz, qw)
        + cov
        + struct.pack("<6d", 0, 0, 0, 0, 0, 0)
        + cov
    )


def write_bag(
    path: str | pathlib.Path,
    scan_stamps: np.ndarray,
    scans: np.ndarray,
    odom_stamps: np.ndarray,
    odom: np.ndarray,
    *,
    angle_min: float,
    angle_max: float,
    range_min: float = 0.02,
    range_max: float = 10.0,
    scan_topic: str = "/scan",
    odom_topic: str = "/odom",
    gt_stamps: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    gt_topic: str = "/ground_truth",
    compression: str = "bz2",
) -> None:
    """Write a chunked ROS1 v2.0 bag with one LaserScan and one Odometry
    stream — plus an optional second Odometry stream (ground truth /
    mocap analog) — interleaved by timestamp (one chunk; compression
    'none' or 'bz2')."""
    scans = np.asarray(scans, np.float32)
    T, B = scans.shape
    a_inc = (angle_max - angle_min) / max(B - 1, 1)

    def _conn(conn_id: int, topic: str, mtype: str, md5: bytes) -> bytes:
        return _record(
            {"op": bytes([_OP_CONNECTION]), "conn": struct.pack("<I", conn_id),
             "topic": topic.encode()},
            _header_bytes({
                "topic": topic.encode(),
                "type": mtype.encode(),
                "md5sum": md5,
                "message_definition": b"",
            }),
        )

    scan_md5 = b"90c7ef2dc6895d81024acba2ac42f369"
    odom_md5 = b"cd5e73d190d741a2f92e81eda573aca7"
    body = _conn(0, scan_topic, LASERSCAN_TYPE, scan_md5)
    body += _conn(1, odom_topic, ODOMETRY_TYPE, odom_md5)
    n_conns = 2
    events = [(float(s), 0, i) for i, s in enumerate(scan_stamps)]
    events += [(float(s), 1, i) for i, s in enumerate(odom_stamps)]
    if gt is not None:
        body += _conn(2, gt_topic, ODOMETRY_TYPE, odom_md5)
        n_conns = 3
        events += [(float(s), 2, i) for i, s in enumerate(gt_stamps)]
    events.sort()

    for stamp, kind, i in events:
        if kind == 0:
            payload = _ser_laserscan(
                stamp, scans[i], angle_min, angle_max, a_inc,
                range_min, range_max,
            )
        elif kind == 1:
            payload = _ser_odometry(stamp, *np.asarray(odom[i], np.float64))
        else:
            payload = _ser_odometry(stamp, *np.asarray(gt[i], np.float64))
        body += _record(
            {"op": bytes([_OP_MSG]), "conn": struct.pack("<I", kind),
             "time": _time_bytes(stamp)},
            payload,
        )

    if compression == "bz2":
        cdata = bz2.compress(body)
    elif compression == "none":
        cdata = body
    else:
        raise ValueError(f"compression {compression!r} not supported")
    chunk = _record(
        {"op": bytes([_OP_CHUNK]), "compression": compression.encode(),
         "size": struct.pack("<I", len(body))},
        cdata,
    )
    bag_header = _record(
        {"op": bytes([_OP_BAG_HEADER]),
         "index_pos": struct.pack("<Q", 0),
         "conn_count": struct.pack("<I", n_conns),
         "chunk_count": struct.pack("<I", 1)},
        b" " * 4096,  # spec: header record padded to 4 KB
    )
    pathlib.Path(path).write_bytes(_MAGIC + bag_header + chunk)
