#!/usr/bin/env python3
"""Hold this tree's kernels K1 and K2 against an earlier tree's, on one
NVIDIA GPU, bit for bit and in time.

    git archive <commit> | tar -x -C build/parent    # build/ is gitignored
    python3 tools/k2_vs_parent.py build/parent

Builds the earlier tree's two CUDA sources with nvcc beside this tree's.
Their C entry points are those of the tree at 7f776cd: icp_p2l_launch
takes (3, B, Ps) source and (4, B, Pt) target planes and no cluster size;
spd_solve_launch takes the arguments this tree's schur_cuda.run_kernel
passes. Then, on seeded inputs:
  * K1 at Ps = Pt (B = 9 Gauss-Newton, B = 512 Censi) and at 256 sources
    against 2,048 targets (B = 8): the (B, 24) output rows of the earlier
    kernel against this one's at every cluster size C, which should be
    equal to the bit; kernel-alone times in the order earlier, C = 1,
    planned C, earlier;
  * K2 on the shapes of its three paths, (1, 512, 3) and (1, 256, 1), in
    both factorization layouts: the factor each kernel leaves in its
    workspace and the solutions, compared bit for bit, and the times.
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
    """The earlier tree's K1 entry point and K2 library, built with this
    tree's nvcc flags."""
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
    k1.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    k1.restype = ctypes.c_int
    k2 = ctypes.CDLL(str(out / "spd_solve_kernel.so"))
    k2.spd_solve_launch.argtypes = schur_cuda._load().spd_solve_launch.argtypes
    k2.spd_solve_launch.restype = ctypes.c_int
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


def room_batch(B: int, seed: int, n: int = 256, ns: int | None = None):
    """B pairs of n wall points of an 8 x 6 m room, each source the target
    seen from a pose within +-0.3 (m, rad); with `ns`, every (n / ns)-th
    target point is a source."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 4, (B, n))
    side = rng.integers(0, 4, (B, n))
    x = np.where(side < 2, t * 2 - 4, np.where(side == 2, -4.0, 4.0))
    y = np.where(side == 0, -3.0, np.where(side == 1, 3.0, t * 1.5 - 3))
    tgt = torch.tensor(np.stack([x, y], -1) + rng.normal(0, 0.005, (B, n, 2)), dtype=torch.float32, device=DEV)
    pose = torch.tensor(rng.uniform(-0.3, 0.3, (B, 3)), dtype=torch.float32, device=DEV)
    mask = torch.ones((B, n), dtype=torch.bool, device=DEV)
    src = geom.inv_apply(pose, tgt)
    if ns is not None:
        src = src[:, :: n // ns].contiguous()
    return src, mask[:, : src.shape[1]].clone(), tgt, mask, torch.zeros((B, 3), device=DEV)


def spd_batch(S: int, n: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n, n))
    H = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=DEV)  # noqa: E731
    return f32(H), f32(rng.normal(size=(S, n, m)))


def k1_case(k1_parent, B: int, censi: bool, n: int, ns: int | None, stream) -> dict:
    pg = PoseGraphParams()
    src, smask, tgt, tmask, seeds = room_batch(B, seed=3, n=n, ns=ns)
    gate = torch.full((B,), pg.icp_coarse_gate_multiplier, device=DEV)
    planes = icp_cuda.pack(src, smask, tgt, tmask, icp.estimate_normals(tgt, tmask), seeds, gate)
    Ps, Pt = src.shape[1], tgt.shape[1]
    old = torch.empty((B, 24), dtype=torch.float32, device=DEV)

    def parent():
        return k1_parent(*(t.data_ptr() for t in planes), old.data_ptr(), B, Ps, Pt, pg.icp_maximum_iterations,
                         icp.anneal_length(pg), pg.icp_max_correspondence_distance,
                         int(pg.icp_use_reciprocal_correspondences), pg.icp_maximum_transformation_epsilon,
                         icp._DAMPING, int(censi), pg.icp_error_delta_rel_tol, stream)

    err = parent()
    new = {C: icp_cuda.run_kernel(*planes, pg, censi, cluster=C) for C in icp_cuda.CLUSTERS}
    torch.cuda.synchronize()
    plan = icp_cuda.launch_plan(B, Ps, Pt, torch.cuda.get_device_properties(DEV).multi_processor_count)
    return {
        "B": B, "Ps": Ps, "Pt": Pt, "censi": censi, "parent_error": err, "plan": plan,
        "equal_to_parent": {C: torch.equal(out, old) for C, out in new.items()},
        "max_abs_diff_to_parent": {C: (out - old).abs().max().item() for C, out in new.items()},
        "columns_differing": {C: torch.nonzero((out != old).any(0)).flatten().tolist() for C, out in new.items()},
        "ms_parent": cuda_ms(parent),
        "ms_c1": cuda_ms(lambda: icp_cuda.run_kernel(*planes, pg, censi, cluster=1)),
        "ms_planned": cuda_ms(lambda: icp_cuda.run_kernel(*planes, pg, censi, cluster=plan)),
        "ms_parent_again": cuda_ms(parent),
    }


def k2_case(k2_parent, S: int, n: int, m: int) -> dict:
    H, Bm = spd_batch(S, n, m)
    out = {}
    times = {}
    for layout in ("single", "multi"):
        for who in ("parent", "this"):
            X, W = torch.empty_like(Bm), torch.empty_like(H)
            # The same wrapper drives both libraries: K2's entry point is unchanged.
            schur_cuda._LIB = k2_parent if who == "parent" else None
            schur_cuda.run_kernel(H, Bm, X, W, layout)
            torch.cuda.synchronize()
            out[who, layout] = (X, W.tril())
            times[f"ms_{who}_{layout}"] = cuda_ms(lambda: schur_cuda.run_kernel(H, Bm, X, W, layout))
    schur_cuda._LIB = None
    return {
        "S": S, "n": n, "m": m,
        **{f"factor_equal_{layout}": torch.equal(out["parent", layout][1], out["this", layout][1])
           for layout in ("single", "multi")},
        **{f"x_equal_{layout}": torch.equal(out["parent", layout][0], out["this", layout][0])
           for layout in ("single", "multi")},
        **times,
    }


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    k1_parent, k2_parent = build_parent(pathlib.Path(sys.argv[1]).resolve())
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for B, censi, n, ns in ((9, False, 256, None), (512, True, 256, None), (8, False, 2048, 256)):
        print(json.dumps({"k1": k1_case(k1_parent, B, censi, n, ns, stream)}), flush=True)
    for S, n, m in ((1, 768, 1), (1, 192, 1), (4, 192, 385), (1, 512, 3), (1, 256, 1)):
        print(json.dumps({"k2": k2_case(k2_parent, S, n, m)}), flush=True)


if __name__ == "__main__":
    main()
