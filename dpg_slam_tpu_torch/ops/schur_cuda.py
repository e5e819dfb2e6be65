"""Host-side wrapper of kernel K2, the hand-written CUDA batched SPD solve
(csrc/spd_solve_kernel.cu) — the port of dpg_slam_tpu/ops/schur_pallas.py
(``spd_solve_pallas`` around the Pallas kernel ``_kernel``).

One CTA per system factors H in a workspace the wrapper allocates, then
solves for B's columns in chunks held in shared memory; see the kernel
source for its layout and what bounds it. The panel width (64, 32 or 16)
and the column chunk are the largest whose shared memory fits one SM.

Build: ops/_nvcc.py compiles the source for sm_90a into a shared library
with a plain C entry point, cached under ``build/kernels/``, at first use.
"""

from __future__ import annotations

import ctypes

import torch

from dpg_slam_tpu_torch.ops import _nvcc

__all__ = ["LAUNCHES", "launch_shape", "run_kernel", "spd_solve_cuda"]

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_SRC = _nvcc.CSRC / "spd_solve_kernel.cu"
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_PANELS = (64, 32, 16)
_MAX_COLS = 256  # one thread per right-hand side in the diagonal-block solves
_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_nvcc.build(_SRC)))
        fn = lib.spd_solve_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # H B X work
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # S n m p cw
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _smem_bytes(n: int, p: int, cw: int) -> int:
    """The kernel's shared memory in bytes (smem_bytes in the source)."""
    return 4 * (n + p * (p + 1) + max((n - p) * (p + 1), n * cw))


def launch_shape(n: int, m: int) -> tuple[int, int]:
    """(panel width, column chunk) for an (n, n) system with m right-hand
    sides: the widest panel whose shared memory fits, then the column chunk
    that splits m evenly into the fewest chunks that fit."""
    for p in _PANELS:
        p = min(p, n)
        if _smem_bytes(n, p, 1) > _SMEM_LIMIT:
            continue
        room = (_SMEM_LIMIT // 4 - n - p * (p + 1)) // n
        cw_max = min(_MAX_COLS, room, m)
        chunks = -(-m // cw_max)
        return p, -(-m // chunks)
    raise ValueError(f"the SPD kernel takes n up to ~3,200; n = {n} does not fit shared memory")


def spd_solve_cuda(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Launch K2 on H (S, n, n) and B (S, n, m), contiguous float32 CUDA
    tensors; returns X (S, n, m) with H X = B."""
    S, n, m = _check(H, B)
    X = torch.empty((S, n, m), dtype=torch.float32, device=H.device)
    work = torch.empty((S, n, n), dtype=torch.float32, device=H.device)
    return run_kernel(H, B, X, work)


def _check(H: torch.Tensor, B: torch.Tensor) -> tuple[int, int, int]:
    if H.device.type != "cuda" or B.device != H.device:
        raise ValueError("spd_solve_cuda takes CUDA tensors on one device")
    if H.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError("spd_solve_cuda takes float32 tensors")
    if H.ndim != 3 or B.ndim != 3:
        raise ValueError(f"spd_solve_cuda takes (S, n, n) and (S, n, m), got {tuple(H.shape)}, {tuple(B.shape)}")
    S, n, _ = H.shape
    if H.shape != (S, n, n) or B.shape[:2] != (S, n):
        raise ValueError(f"shapes {tuple(H.shape)} and {tuple(B.shape)} do not match")
    if not (H.is_contiguous() and B.is_contiguous()):
        raise ValueError("spd_solve_cuda takes contiguous tensors")
    return S, n, B.shape[2]


def run_kernel(H: torch.Tensor, B: torch.Tensor, X: torch.Tensor, work: torch.Tensor) -> torch.Tensor:
    """Launch K2 into X (S, n, m) with the (S, n, n) workspace `work`, both
    contiguous float32 on H's device; returns X."""
    global LAUNCHES
    S, n, m = _check(H, B)
    for t, shape in ((X, (S, n, m)), (work, (S, n, n))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != H.device or not t.is_contiguous():
            raise ValueError(f"run_kernel needs a contiguous float32 {shape} buffer on {H.device}")
    if S == 0 or n == 0 or m == 0:
        return X
    p, cw = launch_shape(n, m)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = _load().spd_solve_launch(
        H.data_ptr(), B.data_ptr(), X.data_ptr(), work.data_ptr(), S, n, m, p, cw, stream,
    )
    if err != 0:
        raise RuntimeError(f"SPD kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return X
