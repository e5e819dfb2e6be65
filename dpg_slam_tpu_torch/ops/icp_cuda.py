"""Host-side wrapper of kernel K1, the hand-written CUDA point-to-line ICP
(csrc/icp_kernel.cu) — the port of dpg_slam_tpu/ops/icp_pallas.py
(``icp_align_pallas`` around the Pallas kernel ``_kernel``).

The kernel replaces the TPU kernel icp_pallas._kernel (+ _finish_iteration,
launched by _run_kernel). One CTA per pair runs the whole ICP loop with the
pair's points in shared memory; see the kernel source for its layout and
what bounds it: at B = 9 (a keyframe batch) 9 of the H100's 132 SMs are
busy and the run is latency-bound; at B ~ 1.7k (the compacted reoptimize
sweep) it is bound by issue of the Ps x Pt distance sweeps. Sources and
targets may differ in count (the DPG local registration aligns 256 sources
against 2,048 targets).

Build: ops/_nvcc.py compiles the source for sm_90a into a shared library
with a plain C entry point, cached under ``build/kernels/``, at first use.
"""

from __future__ import annotations

import ctypes

import torch

from dpg_slam_tpu_torch.config import PoseGraphParams
from dpg_slam_tpu_torch.ops import _nvcc
from dpg_slam_tpu_torch.ops import icp as icp_mod

__all__ = ["LAUNCHES", "icp_align_cuda", "run_kernel"]

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_MASK_COORD = 1e4  # masked points parked at -/+ this: gated out by distance
_OUT_COLS = 24
# 5 * (Ps + Pt) floats of shared memory, plus the kernel's ~0.7 KB of static
# reduction scratch, must fit one block's 227 KB.
_SMEM_LIMIT = 232448
_STATIC_SMEM = 1024

_SRC = _nvcc.CSRC / "icp_kernel.cu"
_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_nvcc.build(_SRC)))
        fn = lib.icp_p2l_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # src tgt seeds out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B Ps Pt max_it anneal
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,  # corr recip eps damp
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,  # censi tol stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def run_kernel(src_planes: torch.Tensor, tgt_planes: torch.Tensor, seeds: torch.Tensor,
               params: PoseGraphParams, censi: bool) -> torch.Tensor:
    """Launch K1 on (3, B, Ps) source planes, (4, B, Pt) target planes and
    (B, 4) seeds; returns the (B, 24) output rows (see the kernel source for
    the columns)."""
    global LAUNCHES
    dev = src_planes.device
    if dev.type != "cuda" or tgt_planes.device != dev or seeds.device != dev:
        raise ValueError("run_kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in (src_planes, tgt_planes, seeds)):
        raise ValueError("run_kernel takes float32 tensors")
    if src_planes.ndim != 3 or src_planes.shape[0] != 3:
        raise ValueError(f"source planes must be (3, B, Ps), got {tuple(src_planes.shape)}")
    _, B, Ps = src_planes.shape
    if tgt_planes.ndim != 3 or tgt_planes.shape[:2] != (4, B):
        raise ValueError(f"target planes must be (4, {B}, Pt), got {tuple(tgt_planes.shape)}")
    Pt = tgt_planes.shape[2]
    if seeds.shape != (B, 4):
        raise ValueError(f"seeds must be ({B}, 4), got {tuple(seeds.shape)}")
    if not all(t.is_contiguous() for t in (src_planes, tgt_planes, seeds)):
        raise ValueError("run_kernel takes contiguous tensors")
    if Ps < 1 or Pt < 1 or 20 * (Ps + Pt) + _STATIC_SMEM > _SMEM_LIMIT:
        raise ValueError(f"the ICP kernel takes 20 (Ps + Pt) + {_STATIC_SMEM} <= {_SMEM_LIMIT} bytes "
                         f"of points, got Ps = {Ps}, Pt = {Pt}")
    out = torch.empty((B, _OUT_COLS), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.icp_p2l_launch(
        src_planes.data_ptr(), tgt_planes.data_ptr(), seeds.data_ptr(), out.data_ptr(),
        B, Ps, Pt, params.icp_maximum_iterations, icp_mod.anneal_length(params),
        params.icp_max_correspondence_distance,
        int(params.icp_use_reciprocal_correspondences),
        params.icp_maximum_transformation_epsilon, icp_mod._DAMPING,
        int(censi), params.icp_error_delta_rel_tol, stream,
    )
    if err != 0:
        raise RuntimeError(f"ICP kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def pack(src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier):
    """Kernel inputs: validity folded into coordinates (masked sources at
    -1e4, masked targets at +1e4, so distance gating alone excludes them)
    as (3, B, Ps) source planes [x, y, mask] and (4, B, Pt) target planes
    [x, y, normal x, normal y], and (B, 4) seeds [tx, ty, th, gate_mult]."""
    src_planes = torch.stack(
        [
            torch.where(src_mask, src[..., 0], -_MASK_COORD),
            torch.where(src_mask, src[..., 1], -_MASK_COORD),
            src_mask.to(torch.float32),
        ]
    ).to(torch.float32).contiguous()
    tgt_planes = torch.stack(
        [
            torch.where(tgt_mask, tgt[..., 0], _MASK_COORD),
            torch.where(tgt_mask, tgt[..., 1], _MASK_COORD),
            tgt_normals[..., 0],
            tgt_normals[..., 1],
        ]
    ).to(torch.float32).contiguous()
    seeds = torch.cat([init_guess, gate_multiplier[:, None]], dim=-1).to(torch.float32).contiguous()
    return src_planes, tgt_planes, seeds


def icp_align_cuda(
    src, src_mask, tgt, tgt_mask, init_guess, params: PoseGraphParams, *,
    tgt_normals, gate_multiplier, min_correspondences, fitness_threshold,
    min_overlap, sensor_noise_std,
) -> icp_mod.ICPResult:
    """ops.icp.icp_align on CUDA tensors through K1 (point-to-line, no
    RANSAC: icp_align raises for the rest before it gets here)."""
    censi = icp_mod.is_censi_mode(params)
    out = run_kernel(*pack(src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier),
                     params, censi)
    H = out[:, [5, 6, 7, 6, 8, 9, 7, 9, 10]].reshape(-1, 3, 3)
    return icp_mod.accept_and_covariance(
        out[:, 0:3], out[:, 3].to(torch.int32), out[:, 4], H,
        out[:, 12:20] if censi else None,
        src_mask=src_mask, init_guess=init_guess, gate_multiplier=gate_multiplier,
        params=params, min_correspondences=min_correspondences,
        fitness_threshold=fitness_threshold, min_overlap=min_overlap,
        sensor_noise_std=sensor_noise_std,
    )
