"""Host-side wrapper of kernel K1, the hand-written CUDA point-to-line ICP
(csrc/icp_kernel.cu) — the port of dpg_slam_tpu/ops/icp_pallas.py
(``icp_align_pallas`` around the Pallas kernel ``_kernel``).

The kernel replaces the TPU kernel icp_pallas._kernel (+ _finish_iteration,
launched by _run_kernel). It runs the whole ICP loop of each pair with the
pair's points in shared memory, in one of two layouts that give the same
output rows to the bit (see the kernel source for the layouts and what
bounds them). ``launch_plan`` picks the cluster size C:

* C = 1, one CTA per pair: any source count; the layout for batches that
  fill the card (the ~1.7k-pair reoptimize sweep);
* C = 2, 4 or 8, one pair over a cluster of C CTAs (Ps <= 256): for small
  batches (a keyframe's 9 pairs, the DPG local registration's 8 pairs of
  256 sources against 2,048 targets), where one CTA per pair leaves most
  SMs idle.

The rule is the largest C with B * C CTAs at most 5 per SM whose shared
memory fits one SM. It comes from chip_smoke.py phase 2, which times every
C on the paths' inputs (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the
table): C = 8 is fastest at B = 9 and at 8 pairs against 2,048 targets
(0.5 CTA an SM); at B = 144, C = 2 and 4 tie ahead of C = 1 and C = 8
(8.7 CTAs an SM, more than run at once) is slowest; at B = 1,728, C = 1
and 2 are within a few per cent and larger clusters slower.

Build: ops/_nvcc.py compiles the source for sm_90a into a shared library
with a plain C entry point, cached under ``build/kernels/``, at first use.
"""

from __future__ import annotations

import ctypes

import torch

from dpg_slam_tpu_torch.config import PoseGraphParams
from dpg_slam_tpu_torch.ops import _nvcc
from dpg_slam_tpu_torch.ops import icp as icp_mod
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["CLUSTERS", "icp_align_cuda", "launch_plan", "run_kernel", "smem_bytes"]

_MASK_COORD = 1e4  # masked points parked at -/+ this: gated out by distance
_OUT_COLS = 24
_THREADS = 256  # kThreads in the source: one CTA's threads, and its source slots at C = 1
CLUSTERS = (1, 2, 4, 8)  # the cluster sizes the kernel takes (portable sizes)
_CTAS_PER_SM = 5  # launch_plan: most CTAs an SM for a cluster layout
# Dynamic shared memory (smem_bytes) plus the kernel's static reduction
# scratch (2 x 8 x 19 + 19 + 5 floats) must fit one block's 227 KB.
_SMEM_LIMIT = 232448
_STATIC_SMEM = 4 * (2 * 8 * 19 + 19 + 5)

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
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # censi tol cluster stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def smem_bytes(Ps: int, Pt: int, C: int) -> int:
    """Dynamic shared memory of one CTA in bytes (smem_bytes in the
    source): targets and normals as float2 and the col-min (5 Pt floats),
    the CTA's sources, their moved copies (5 per source slot: Ps at C = 1,
    256 / C in a cluster); a cluster adds every rank's partial col-min
    (C x Pt) and the per-slice match results (6 x 256)."""
    slots = Ps if C == 1 else _THREADS // C
    extra = 0 if C == 1 else C * Pt + 6 * _THREADS
    return 4 * (5 * (slots + Pt) + extra)


def _fits(Ps: int, Pt: int, C: int) -> bool:
    return smem_bytes(Ps, Pt, C) + _STATIC_SMEM <= _SMEM_LIMIT


def launch_plan(B: int, Ps: int, Pt: int, num_sms: int) -> int:
    """The cluster size C for B pairs of Ps sources against Pt targets on a
    card of num_sms SMs: the largest C of 8, 4, 2 with B * C within
    _CTAS_PER_SM CTAs an SM, Ps <= 256 and shared memory that fits; else
    1 (see the module docstring for the measurements behind the rule)."""
    for C in (8, 4, 2):
        if B * C <= _CTAS_PER_SM * num_sms and Ps <= _THREADS and _fits(Ps, Pt, C):
            return C
    return 1


def run_kernel(src_planes: torch.Tensor, tgt_planes: torch.Tensor, seeds: torch.Tensor,
               params: PoseGraphParams, censi: bool, cluster: int | None = None) -> torch.Tensor:
    """Launch K1 on (3, B, Ps) source planes, (4, B, Pt) target planes and
    (B, 4) seeds; returns the (B, 24) output rows (see the kernel source for
    the columns). `cluster` (1, 2, 4 or 8) overrides launch_plan's layout,
    to compare them; a size the kernel does not take raises. Each launch
    adds 1 to the counter k1.launches (utils.profiling)."""
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
    if cluster is None:
        C = launch_plan(B, Ps, Pt, torch.cuda.get_device_properties(dev).multi_processor_count)
    elif cluster not in CLUSTERS or (cluster > 1 and Ps > _THREADS):
        raise ValueError(f"the ICP kernel takes a cluster of {CLUSTERS} CTAs, more than 1 only for "
                         f"Ps <= {_THREADS}; got {cluster} at Ps = {Ps}")
    else:
        C = cluster
    if Ps < 1 or Pt < 1 or not _fits(Ps, Pt, C):
        raise ValueError(f"the ICP kernel takes {smem_bytes(Ps, Pt, C)} bytes of shared memory for Ps = {Ps}, "
                         f"Pt = {Pt} at C = {C}; one SM holds {_SMEM_LIMIT - _STATIC_SMEM}")
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
        int(censi), params.icp_error_delta_rel_tol, C, stream,
    )
    if err != 0:
        raise RuntimeError(f"ICP kernel launch failed (cluster of {C}): cudaError {err}")
    profiling.count("k1.launches")
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
    RANSAC: icp_align sends the rest to the plain version)."""
    censi = icp_mod.is_censi_mode(params)
    out = run_kernel(*pack(src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier),
                     params, censi)
    # The Hessian's six sums (h00 h01 h02 h11 h12 h22) as a symmetric 3x3;
    # built from slices, as a list index would copy its indices to the
    # card and wait for the stream.
    h = out[:, 5:11]
    H = torch.stack([h[:, i] for i in (0, 1, 2, 1, 3, 4, 2, 4, 5)], dim=-1).reshape(-1, 3, 3)
    return icp_mod.accept_and_covariance(
        out[:, 0:3], out[:, 3].to(torch.int32), out[:, 4], H,
        out[:, 12:20] if censi else None,
        src_mask=src_mask, init_guess=init_guess, gate_multiplier=gate_multiplier,
        params=params, min_correspondences=min_correspondences,
        fitness_threshold=fitness_threshold, min_overlap=min_overlap,
        sensor_noise_std=sensor_noise_std,
    )
