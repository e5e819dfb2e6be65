"""Sequence log persistence — the port's copy of dpg_slam_tpu/io/logs.py.

A session is (scans, odometry[, ground_truth]) arrays, in one of two
formats:

  * ``.npz`` — a numpy archive;
  * ``.dsl`` — the binary log of the C++ host runtime (native/log_io.cc),
    read and written through ctypes when native/build/libdpgslam_host.so
    loads, else by the pure-Python reader and writer below, which give the
    same bytes. Both are host I/O; ``dsl_reader()`` says which one runs.

The .dsl layout (little-endian):
  magic  u32 = 0x44504C31 ("DPL1")
  T      u32   timesteps
  B      u32   beams per scan
  flags  u32   bit0: has ground truth
  scans      f32[T, B]
  odometry   f32[T, 3]
  ground_truth f32[T, 3]   (iff flag)
"""

from __future__ import annotations

import ctypes
import pathlib
import struct

import numpy as np

from dpg_slam_tpu_torch.io.dataset import Sequence

__all__ = ["save_sequence", "load_sequence", "native_lib", "dsl_reader"]

_MAGIC = 0x44504C31
_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _find_native() -> ctypes.CDLL | None:
    so = pathlib.Path(__file__).resolve().parents[2] / "native" / "build" / "libdpgslam_host.so"
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.dsl_read_header.argtypes = [ctypes.c_char_p, _U32P, _U32P, _U32P]
    lib.dsl_read_header.restype = ctypes.c_int
    lib.dsl_read.argtypes = [ctypes.c_char_p, _F32P, _F32P, _F32P]
    lib.dsl_read.restype = ctypes.c_int
    lib.dsl_write.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                              _F32P, _F32P, _F32P]
    lib.dsl_write.restype = ctypes.c_int
    return lib


_native = None
_native_checked = False


def native_lib() -> ctypes.CDLL | None:
    """The C++ host-runtime library, or None if it is not built or does not
    load on this machine."""
    global _native, _native_checked
    if not _native_checked:
        _native = _find_native()
        _native_checked = True
    return _native


def dsl_reader() -> str:
    """Which .dsl reader and writer run here: "native" or "python"."""
    return "native" if native_lib() is not None else "python"


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _save_dsl_python(path: pathlib.Path, scans, odom, gt, has_gt: bool) -> None:
    T, B = scans.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<IIII", _MAGIC, T, B, 1 if has_gt else 0))
        f.write(scans.tobytes())
        f.write(odom.tobytes())
        if has_gt:
            f.write(gt.tobytes())


def _load_dsl_python(path: pathlib.Path) -> Sequence:
    with open(path, "rb") as f:
        head = f.read(16)
        if len(head) != 16:
            raise IOError(f"{path}: truncated header")
        magic, T, B, flags = struct.unpack("<IIII", head)
        if magic != _MAGIC:
            raise IOError(f"{path}: bad magic {magic:#x}")
        n_gt = T * 3 if flags & 1 else 0
        body = np.frombuffer(f.read(4 * (T * B + T * 3 + n_gt)), np.float32)
    if body.size != T * B + T * 3 + n_gt:
        raise IOError(f"{path}: truncated body")
    scans = body[: T * B].reshape(T, B).copy()
    odom = body[T * B: T * B + T * 3].reshape(T, 3).copy()
    gt = body[T * B + T * 3:].reshape(T, 3).copy() if flags & 1 else None
    return Sequence(scans=scans, odometry=odom, ground_truth=gt)


def _load_dsl_native(lib, path: pathlib.Path) -> Sequence:
    T, B, flags = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
    ret = lib.dsl_read_header(str(path).encode(), ctypes.byref(T), ctypes.byref(B), ctypes.byref(flags))
    if ret != 0:
        raise IOError(f"native dsl_read_header failed with code {ret}")
    T, B, flags = T.value, B.value, flags.value
    scans = np.empty((T, B), np.float32)
    odom = np.empty((T, 3), np.float32)
    gt = np.empty((T if flags & 1 else 0, 3), np.float32)
    ret = lib.dsl_read(str(path).encode(), _ptr(scans), _ptr(odom), _ptr(gt))
    if ret != 0:
        raise IOError(f"native dsl_read failed with code {ret}")
    return Sequence(scans=scans, odometry=odom, ground_truth=gt if flags & 1 else None)


def save_sequence(path: str | pathlib.Path, seq: Sequence) -> None:
    path = pathlib.Path(path)
    if path.suffix == ".npz":
        np.savez_compressed(path, scans=seq.scans, odometry=seq.odometry, ground_truth=seq.ground_truth)
        return
    if path.suffix != ".dsl":
        raise ValueError(f"unknown log format {path.suffix}")
    has_gt = seq.ground_truth is not None
    scans = np.ascontiguousarray(seq.scans, np.float32)
    odom = np.ascontiguousarray(seq.odometry, np.float32)
    gt = np.ascontiguousarray(seq.ground_truth if has_gt else np.zeros((0, 3)), np.float32)
    lib = native_lib()
    if lib is None:
        _save_dsl_python(path, scans, odom, gt, has_gt)
        return
    T, B = scans.shape
    ret = lib.dsl_write(str(path).encode(), T, B, 1 if has_gt else 0, _ptr(scans), _ptr(odom), _ptr(gt))
    if ret != 0:
        raise IOError(f"native dsl_write failed with code {ret}")


def load_sequence(path: str | pathlib.Path) -> Sequence:
    path = pathlib.Path(path)
    if path.suffix == ".npz":
        data = np.load(path)
        return Sequence(scans=data["scans"], odometry=data["odometry"], ground_truth=data.get("ground_truth"))
    if path.suffix != ".dsl":
        raise ValueError(f"unknown log format {path.suffix}")
    lib = native_lib()
    return _load_dsl_python(path) if lib is None else _load_dsl_native(lib, path)
