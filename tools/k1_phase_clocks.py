#!/usr/bin/env python3
"""Where K1's time goes inside one ICP pass, on one NVIDIA GPU.

    python3 tools/k1_phase_clocks.py

Builds csrc/icp_kernel.cu with -DICP_PHASE_CLOCKS (thread 0 of each CTA
adds the SM clocks of each phase of a pass; see the kernel source) beside
the normal build, and runs it on chip_smoke.py's phase 2 inputs (the
keyframe batch, the reoptimize sweep, 8 pairs of 256 sources against
2,048 targets, the keyframe batch tiled 16 times) at every cluster size
the shape admits. Prints one JSON line per (input, C): the instrumented
kernel's milliseconds (CUDA events; the clock reads cost a few per cent),
pair 0's passes (iterations + the final pass), and block 0's clocks per
pass in each phase. At C = 1 the barrier and combine phases only wait for
the CTA's other warps. The first line is the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from dpg_slam_tpu_torch.config import DpgConfig  # noqa: E402
from dpg_slam_tpu_torch.ops import _nvcc, icp, icp_cuda  # noqa: E402

PHASES = ("transform", "colmin_own", "barrier1", "colmin_combine", "match_terms", "warp_sums", "barrier2",
          "totals", "solve")


def build():
    out = _nvcc._BUILD_DIR / "icp_kernel_phase_clocks.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc._nvcc(), *_nvcc._NVCC_FLAGS, "-DICP_PHASE_CLOCKS", "-o", str(out), str(icp_cuda._SRC)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.icp_p2l_launch.argtypes = icp_cuda._load().icp_p2l_launch.argtypes
    lib.icp_p2l_launch.restype = ctypes.c_int
    lib.icp_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.icp_phase_clocks.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_phase_clocks.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = build()
    cfg = DpgConfig.from_json((cs.ASSETS / "keyframe" / "config.json").read_text())
    pg = cfg.pose_graph
    kf_args, kf_normals, kf_gate = cs.keyframe_batch(cfg)
    ro_args, ro_normals, ro_gate, _ = cs.reoptimize_batch(cfg)
    lr_args, lr_normals, lr_gate = cs.local_reg_batch()
    x16 = tuple(t.repeat(16, *([1] * (t.ndim - 1))) for t in kf_args)
    cases = {
        "keyframe": (kf_args, kf_normals, kf_gate),
        "reoptimize": (ro_args, ro_normals, ro_gate),
        "local_reg_256_2048": (lr_args, lr_normals, lr_gate),
        "keyframe_x16": (x16, kf_normals.repeat(16, 1, 1), kf_gate.repeat(16)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for name, (args, normals, gate) in cases.items():
        planes = icp_cuda.pack(*args[:4], normals, args[4], gate)
        _, B, Ps = planes[0].shape
        Pt = planes[1].shape[2]
        for C in icp_cuda.CLUSTERS:
            if C > 1 and Ps > 256:
                continue
            out = torch.empty((B, 24), device=cs.DEVICE)

            def run():
                err = lib.icp_p2l_launch(
                    *(t.data_ptr() for t in planes), out.data_ptr(), B, Ps, Pt, pg.icp_maximum_iterations,
                    icp.anneal_length(pg), pg.icp_max_correspondence_distance,
                    int(pg.icp_use_reciprocal_correspondences), pg.icp_maximum_transformation_epsilon,
                    icp._DAMPING, 0, pg.icp_error_delta_rel_tol, C, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            ms = cs.cuda_ms(run, 10)  # the last launch's clocks are read below
            clk = (ctypes.c_ulonglong * len(PHASES))()
            if lib.icp_phase_clocks(ctypes.addressof(clk)) != 0:
                raise RuntimeError("reading the phase clocks failed")
            passes = out[0, 11].item() + 1
            print(json.dumps({
                "case": name, "B": B, "Ps": Ps, "Pt": Pt, "C": C, "ms_instrumented": ms, "passes_pair0": passes,
                "clocks_per_pass": {p: clk[k] / passes for k, p in enumerate(PHASES)},
            }), flush=True)


if __name__ == "__main__":
    main()
