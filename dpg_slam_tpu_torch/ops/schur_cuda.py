"""Host-side wrapper of kernel K2, the hand-written CUDA batched SPD solve
(csrc/spd_solve_kernel.cu) — the port of dpg_slam_tpu/ops/schur_pallas.py
(``spd_solve_pallas`` around the Pallas kernel ``_kernel``).

H is factored in a workspace the wrapper allocates, then B's columns are
solved in chunks held in shared memory; see the kernel source for the
layouts and what bounds them. ``launch_plan`` picks, from (S, n, m):

* the factorization: "single" (one CTA per system) for n <= 224, "multi"
  (per panel, one launch that factors the diagonal tile and solves the
  panel over several CTAs and one launch over the 64 x 64 tiles of the
  trailing update; 2 n / p launches in all) for n >= 225. Both leave the
  same factor to the bit. The threshold comes from the paths' inputs
  (chip_smoke.py phase 2b, NVIDIA H100 80GB HBM3 at 700 W): at n = 768
  the multi layout takes 0.95 ms against 2.45 ms; on the n = 192 inputs
  (three panels) its extra launches cost 1-3 % more than the one SM
  loses (0.199 against 0.194 ms, 1.10 against 1.09 ms). At n = 256, the
  smallest n above the threshold that tools/k2_vs_parent.py times, multi
  is ahead. S does not enter the rule: the measured inputs have S <= 4,
  far below the card's 132 SMs.
* the substitution: one warp per right-hand side with the panel rows
  staged through shared memory for m < 32, one thread per right-hand side
  for m >= 32;
* the panel width (64, 32 or 16) and the column chunk: the largest whose
  shared memory fits one SM.

Build: ops/_nvcc.py compiles the source for sm_90a into a shared library
with a plain C entry point, cached under ``build/kernels/``, at first use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dpg_slam_tpu_torch.ops import _nvcc
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["LaunchPlan", "launch_plan", "launch_shape", "run_kernel", "spd_solve_cuda"]

_SRC = _nvcc.CSRC / "spd_solve_kernel.cu"
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_PANELS = (64, 32, 16)
_MAX_COLS = 256  # one thread per right-hand side in the diagonal-block solves
_SMALL_M = 32  # m below this: warp-per-column substitution (kernel: solve_few_columns)
_STAGE_ROWS = 256  # kStageRows in the source
_MULTI_MIN_N = 225  # n from which the factorization spreads over many CTAs
_LIB = None


class LaunchPlan(NamedTuple):
    factorization: str  # "single" or "multi"
    panel: int
    cols: int  # right-hand sides per chunk
    small_m: bool  # warp-per-column substitution


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_nvcc.build(_SRC)))
        fn = lib.spd_solve_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # H B X
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # work inv dfac
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # S n m p cw
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # small multi stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _smem_bytes(n: int, p: int, cw: int, small: bool) -> int:
    """spd_solve_kernel's shared memory in bytes when it factors
    (smem_bytes in the source)."""
    stage = _STAGE_ROWS * (p + 1) if small else 0
    return 4 * (n + p * (p + 1) + max((n - p) * (p + 1), n * cw + stage))


def launch_shape(n: int, m: int) -> tuple[int, int]:
    """(panel width, column chunk) for an (n, n) system with m right-hand
    sides: the widest panel whose shared memory fits, then the column chunk
    that splits m evenly into the fewest chunks that fit."""
    small = m < _SMALL_M
    for p in _PANELS:
        p = min(p, n)
        if _smem_bytes(n, p, 1, small) > _SMEM_LIMIT:
            continue
        stage = _STAGE_ROWS * (p + 1) if small else 0
        room = (_SMEM_LIMIT // 4 - n - p * (p + 1) - stage) // n
        cw_max = min(_MAX_COLS, room, m)
        chunks = -(-m // cw_max)
        return p, -(-m // chunks)
    raise ValueError(f"the SPD kernel takes n up to ~3,200; n = {n} does not fit shared memory")


def launch_plan(S: int, n: int, m: int) -> LaunchPlan:
    """How K2 solves S systems (n, n) with m right-hand sides (see the
    module docstring for the rule and its threshold)."""
    del S  # measured inputs have S <= 4; see the module docstring
    p, cw = launch_shape(n, m)
    return LaunchPlan("multi" if n >= _MULTI_MIN_N else "single", p, cw, m < _SMALL_M)


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


def run_kernel(H: torch.Tensor, B: torch.Tensor, X: torch.Tensor, work: torch.Tensor,
               factorization: str | None = None) -> torch.Tensor:
    """Launch K2 into X (S, n, m) with the (S, n, n) workspace `work`, both
    contiguous float32 on H's device; returns X, and leaves H's Cholesky
    factor in work's lower triangle. `factorization` ("single" or "multi")
    overrides launch_plan's choice, to compare the two layouts. Each call
    of the kernel's entry point adds 1 to the counter k2.launches
    (utils.profiling), whatever the number of launches it issues."""
    S, n, m = _check(H, B)
    for t, shape in ((X, (S, n, m)), (work, (S, n, n))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != H.device or not t.is_contiguous():
            raise ValueError(f"run_kernel needs a contiguous float32 {shape} buffer on {H.device}")
    if S == 0 or n == 0 or m == 0:
        return X
    plan = launch_plan(S, n, m)
    if factorization is not None:
        if factorization not in ("single", "multi"):
            raise ValueError(f"factorization is 'single' or 'multi', got {factorization!r}")
        plan = plan._replace(factorization=factorization)
    multi = plan.factorization == "multi"
    p = plan.panel
    # Multi layout scratch: reciprocal pivots (S, n), then one factored
    # diagonal tile per system (S, p, p).
    scratch = torch.empty(S * (n + p * p) if multi else 0, dtype=torch.float32, device=H.device)
    inv, dfac = (scratch.data_ptr(), scratch[S * n:].data_ptr()) if multi else (None, None)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = _load().spd_solve_launch(
        H.data_ptr(), B.data_ptr(), X.data_ptr(), work.data_ptr(), inv, dfac,
        S, n, m, p, plan.cols, int(plan.small_m), int(multi), stream,
    )
    if err != 0:
        raise RuntimeError(f"SPD kernel launch failed: cudaError {err}")
    profiling.count("k2.launches")
    return X
