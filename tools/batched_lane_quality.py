#!/usr/bin/env python3
"""Lane quality of the session-batched mode on one NVIDIA GPU, by the
linear solve inside its LM steps.

    python3 tools/batched_lane_quality.py [runs] [stride]

Runs process_sessions_batched at chip_smoke.py phase 9's configuration
(16 simulated sessions of 3 office laps, "lanes_chol", GN 5; a solve every
`stride` keyframes, default 32) `runs` times (default 10) with each of
four linear solves of the lanes' damped (S, 3N, 3N) systems:

  lanes           the port's: torch.linalg Cholesky one lane at a time
  batched_linalg  one batched torch.linalg.cholesky_ex + cholesky_solve
  k2              ops.schur.spd_solve (kernel K2)
  lanes_f64       lane at a time, in float64

Prints one JSON line per variant: per run the largest and the mean lane
ATE (m) in the anchored frame (as the tests measure it), the largest
after a best-fit SE(2) alignment of each lane (the trajectory's shape
without where its first pose ended up), how many runs had a lane at or
above 0.25 m, the factorizations the batched torch.linalg call reported
failed, and the median run's seconds. The first line is the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from dpg_slam_tpu_torch.graph import factor_graph as fg  # noqa: E402
from dpg_slam_tpu_torch.ops import _nvcc, icp_cuda, schur, schur_cuda  # noqa: E402

FAILED = [0]


def batched_linalg(eq, g, damping):
    S, N = eq.diag.shape[:2]
    L, info = torch.linalg.cholesky_ex(fg._dense_H(eq, g, damping))
    FAILED[0] += int((info != 0).sum())  # a host read: this variant is a diagnostic
    x = torch.cholesky_solve(eq.rhs.reshape(S, 3 * N, 1), L)
    return torch.where((info == 0)[:, None, None], x, float("nan")).reshape(S, N, 3)


def k2(eq, g, damping):
    S, N = eq.diag.shape[:2]
    return schur.spd_solve(fg._dense_H(eq, g, damping), eq.rhs.reshape(S, 3 * N, 1)).reshape(S, N, 3)


def lanes_f64(eq, g, damping):
    S, N = eq.diag.shape[:2]
    H = fg._dense_H(eq, g, damping).double()
    b = eq.rhs.reshape(S, 3 * N, 1).double()
    out = []
    for s in range(S):
        L, info = torch.linalg.cholesky_ex(H[s])
        out.append(torch.where(info == 0, torch.cholesky_solve(b[s], L), float("nan")))
    return torch.stack(out).float().reshape(S, N, 3)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("batched_lane_quality.py needs a CUDA device")
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    stride = int(sys.argv[2]) if len(sys.argv) > 2 else cs.BATCH_STRIDE
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _nvcc.build_all([icp_cuda._SRC, schur_cuda._SRC])
    cfg = cs.batched_config()
    sessions, gts = cs.batched_sessions(cfg, cs.BATCH_SESSIONS, cs.BATCH_LAPS)
    lanes = fg._dense_solve_lanes
    for name, solve in (("lanes", lanes), ("batched_linalg", batched_linalg), ("k2", k2), ("lanes_f64", lanes_f64)):
        fg._dense_solve_lanes = solve
        FAILED[0] = 0
        maxes, means, aligned, secs = [], [], [], []
        try:
            for _ in range(runs):
                states, counts, dt = cs.run_batched(cfg, sessions, solve_method=cs.BATCH_METHOD,
                                                    solve_stride=stride, solve_gn_iterations=cs.BATCH_GN)
                ates = cs.lane_ates(cfg, states, sessions, gts, counts)
                maxes.append(max(ates))
                aligned.append(max(cs.lane_ates(cfg, states, sessions, gts, counts, align=True)))
                means.append(float(np.mean(ates)))
                secs.append(dt)
        finally:
            fg._dense_solve_lanes = lanes
        print(json.dumps({
            "solve": name, "stride": stride, "runs": runs, "max_lane_ate_m": maxes, "mean_lane_ate_m": means,
            "max_aligned_lane_ate_m": aligned,
            "runs_with_a_lane_over_0.25_m": sum(m >= cs.LANE_ATE_MAX for m in maxes),
            "batched_linalg_failed_factorizations": FAILED[0] if name == "batched_linalg" else None,
            "median_seconds": float(np.median(secs)),
        }), flush=True)


if __name__ == "__main__":
    main()
