#!/usr/bin/env python3
"""Hold this tree's kernels K1 and K2 against an earlier tree's, on one
NVIDIA GPU, bit for bit and in time.

    git archive <commit> | tar -x -C build/parent    # build/ is gitignored
    python3 tools/k2_vs_parent.py build/parent

Builds the earlier tree's two CUDA sources with nvcc beside this tree's
(their C entry points take one point count in icp_p2l_launch and one
layout in spd_solve_launch), then on seeded inputs:
  * K1 with as many sources as targets: the (B, 24) output rows of both
    kernels, which should be equal to the bit;
  * K2 on the shapes of its three paths, (1, 512, 3) and (1, 256, 1), the
    smallest n of the many-CTA layout's range: the factor each
    leaves in its workspace (parent, this tree's one-CTA layout, its
    many-CTA layout) and the solutions, compared bit for bit, and the
    kernel-alone times in the order parent, single, multi, parent.
Prints one JSON line per case; the first line is the card's nvidia-smi
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from dpg_slam_tpu_torch import geom  # noqa: E402
from dpg_slam_tpu_torch.config import PoseGraphParams  # noqa: E402
from dpg_slam_tpu_torch.ops import _nvcc, icp, icp_cuda, schur_cuda  # noqa: E402

DEV = torch.device("cuda")


def build_parent(tree: pathlib.Path):
    out = tree / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("icp_kernel", "spd_solve_kernel"):
        src = tree / "dpg_slam_tpu_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen([_nvcc._nvcc(), *_nvcc._NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(src)])
    _nvcc.build_all([icp_cuda._SRC, schur_cuda._SRC])
    for p in procs.values():
        if p.wait() != 0:
            raise RuntimeError("nvcc failed on the parent's sources")
    k1 = ctypes.CDLL(str(out / "icp_kernel.so")).icp_p2l_launch
    k1.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    k2 = ctypes.CDLL(str(out / "spd_solve_kernel.so")).spd_solve_launch
    k2.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return k1, k2


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def room_batch(B: int, seed: int, n: int = 256):
    """B pairs of n wall points of an 8 x 6 m room, each source the target
    seen from a pose within +-0.3 (m, rad)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 4, (B, n))
    side = rng.integers(0, 4, (B, n))
    x = np.where(side < 2, t * 2 - 4, np.where(side == 2, -4.0, 4.0))
    y = np.where(side == 0, -3.0, np.where(side == 1, 3.0, t * 1.5 - 3))
    tgt = torch.tensor(np.stack([x, y], -1) + rng.normal(0, 0.005, (B, n, 2)), dtype=torch.float32, device=DEV)
    pose = torch.tensor(rng.uniform(-0.3, 0.3, (B, 3)), dtype=torch.float32, device=DEV)
    mask = torch.ones((B, n), dtype=torch.bool, device=DEV)
    return geom.inv_apply(pose, tgt), mask, tgt, mask.clone(), torch.zeros((B, 3), device=DEV)


def spd_batch(S: int, n: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n, n))
    H = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=DEV)  # noqa: E731
    return f32(H), f32(rng.normal(size=(S, n, m)))


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    k1_parent, k2_parent = build_parent(pathlib.Path(sys.argv[1]).resolve())
    stream = torch.cuda.current_stream(DEV).cuda_stream
    pg = PoseGraphParams()
    for B, censi in ((9, False), (512, True)):
        src, smask, tgt, tmask, seeds = room_batch(B, seed=3)
        gate = torch.full((B,), pg.icp_coarse_gate_multiplier, device=DEV)
        src_planes, tgt_planes, kseeds = icp_cuda.pack(src, smask, tgt, tmask, icp.estimate_normals(tgt, tmask),
                                                       seeds, gate)
        new = icp_cuda.run_kernel(src_planes, tgt_planes, kseeds, pg, censi)
        planes = torch.cat([src_planes[:2], tgt_planes, src_planes[2:]]).contiguous()  # the parent's 7 planes
        old = torch.empty_like(new)
        err = k1_parent(planes.data_ptr(), kseeds.data_ptr(), old.data_ptr(), B, src.shape[1],
                        pg.icp_maximum_iterations, icp.anneal_length(pg), pg.icp_max_correspondence_distance,
                        int(pg.icp_use_reciprocal_correspondences), pg.icp_maximum_transformation_epsilon,
                        icp._DAMPING, int(censi), pg.icp_error_delta_rel_tol, stream)
        torch.cuda.synchronize()
        print(json.dumps({"k1": {"B": B, "censi": censi, "parent_error": err, "equal": torch.equal(new, old)}}),
              flush=True)
    for S, n, m in ((1, 768, 1), (1, 192, 1), (4, 192, 385), (1, 512, 3), (1, 256, 1)):
        H, Bm = spd_batch(S, n, m)
        p, cw = schur_cuda.launch_shape(n, m)
        if m < schur_cuda._SMALL_M:  # the parent's column chunk had no staging term
            room = (schur_cuda._SMEM_LIMIT // 4 - n - p * (p + 1)) // n
            cw = -(-m // -(-m // min(schur_cuda._MAX_COLS, room, m)))
        out = {name: (torch.empty_like(Bm), torch.empty_like(H)) for name in ("parent", "single", "multi")}

        def parent():
            X, W = out["parent"]
            return k2_parent(H.data_ptr(), Bm.data_ptr(), X.data_ptr(), W.data_ptr(), S, n, m, p, cw, stream)

        err = parent()
        for layout in ("single", "multi"):
            schur_cuda.run_kernel(H, Bm, *out[layout], layout)
        torch.cuda.synchronize()
        factor = {k: w.tril() for k, (_, w) in out.items()}
        print(json.dumps({"k2": {
            "S": S, "n": n, "m": m, "parent_error": err,
            "factor_parent_eq_single": torch.equal(factor["parent"], factor["single"]),
            "factor_single_eq_multi": torch.equal(factor["single"], factor["multi"]),
            "x_parent_eq_single": torch.equal(out["parent"][0], out["single"][0]),
            "x_parent_vs_single_max_abs": (out["parent"][0] - out["single"][0]).abs().max().item(),
            "x_single_eq_multi": torch.equal(out["single"][0], out["multi"][0]),
            "ms_parent": cuda_ms(parent),
            "ms_single": cuda_ms(lambda: schur_cuda.run_kernel(H, Bm, *out["single"], "single")),
            "ms_multi": cuda_ms(lambda: schur_cuda.run_kernel(H, Bm, *out["multi"], "multi")),
            "ms_parent_again": cuda_ms(parent),
        }}), flush=True)


if __name__ == "__main__":
    main()
