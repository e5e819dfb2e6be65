#!/usr/bin/env python3
"""K2's accuracy gates on repeated captures of its ill-conditioned inputs
(one NVIDIA GPU).

    python3 tools/k2_capture_repeats.py [captures] [lane_captures]

chip_smoke.py phase 2b checks K2 on the first system that the dense_pallas
reoptimize of bench_assets/session hands it, and phase 9c on the first
lanes Cholesky system of the batched mode. Both systems are assembled with
float atomics, so they change from run to run, and the first is
conditioned ~1e10. This script captures the first `captures` times
(default 12) and the second `lane_captures` times (default 4) and prints,
for each capture, every float32 solution's relative max-norm distance from
the plain version and from a float64 solve of the same system (for the
lanes system also lane by lane, with each lane's condition number), the
factors' residuals, and whether the gates of chip_smoke.py's
`k2_accuracy` hold on it, and whether K2 is within twice the library's
(or the lanes form's) distance from plain: phase 9c's forward gate, and
phase 2b's before it was held to the float64 solve.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def gates(name, H, B, ker, ker_factor, lib_factor, forward, **others) -> dict:
    """The float64 distances of chip_smoke.k2_accuracy and whether its
    gates hold."""
    try:
        cs.k2_accuracy(name, H, B, ker, ker_factor, lib_factor, forward, **others)
        holds = True
    except AssertionError:
        holds = False
    acc = cs.f64_distances(H, B, kernel=ker, **others)
    return dict(acc, factor_residual_kernel=cs.factor_residual(H, ker_factor),
                factor_residual_library=cs.factor_residual(H, lib_factor), k2_accuracy_holds=holds)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("k2_capture_repeats.py needs a CUDA device")
    captures = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    lane_captures = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    cs._nvcc.build_all([cs.schur_cuda._SRC, cs.icp_cuda._SRC])
    cs.schur_cuda._load()
    cs.icp_cuda._load()

    def dist(a, b, scale):
        return ((a.double() - b.double()).abs().max() / scale).item()

    for r in range(captures):
        H, B = cs.capture_spd_input(lambda: cs.run_reoptimize(cs.DEVICE, "dense_pallas"))
        ker = cs.schur.spd_solve(H, B)
        ref = cs.schur.spd_solve_plain(H, B)
        L = torch.linalg.cholesky_ex(H)[0]
        lib = torch.cholesky_solve(B, L)
        work = torch.empty_like(H)
        cs.schur_cuda.run_kernel(H, B, torch.empty_like(B), work)
        scale = ref.abs().max()
        print(json.dumps(dict(
            case="reoptimize_dense", capture=r, k_vs_plain=dist(ker, ref, scale), lib_vs_plain=dist(lib, ref, scale),
            plain_gate_fails=dist(ker, ref, scale) > max(cs.K2_REL, 2.0 * dist(lib, ref, scale)),
            **gates("reoptimize_dense", H, B, ker, work, L, True, library=lib, plain=ref),
        )), flush=True)

    if lane_captures:
        cfg = cs.batched_config()
        sessions, _ = cs.batched_sessions(cfg, cs.BATCH_SESSIONS, cs.BATCH_LAPS)
        for r in range(lane_captures):
            _, _, (H, B) = cs.captured_step_loop(cfg, sessions, capture_step=0)
            ker = cs.schur.spd_solve(H, B)
            ref = cs.schur.spd_solve_plain(H, B)
            L = torch.stack([torch.linalg.cholesky_ex(H[s])[0] for s in range(H.shape[0])])
            lanes = torch.stack([torch.cholesky_solve(B[s], L[s]) for s in range(H.shape[0])])
            work = torch.empty_like(H)
            cs.schur_cuda.run_kernel(H, B, torch.empty_like(B), work)
            scale = ref.abs().max()
            x64 = torch.linalg.solve(H.double(), B.double())
            per_lane = {k: [dist(x[s], x64[s], x64[s].abs().max()) for s in range(H.shape[0])]
                        for k, x in (("kernel", ker), ("lanes_form", lanes), ("plain", ref))}
            print(json.dumps(dict(
                case="batched_lanes", capture=r, k_vs_plain=dist(ker, ref, scale),
                lane_cond=torch.linalg.cond(H.double()).tolist(), lane_vs_f64=per_lane,
                lanes_vs_plain=dist(lanes, ref, scale),
                plain_gate_fails=dist(ker, ref, scale) > max(cs.K2_REL, 2.0 * dist(lanes, ref, scale)),
                **gates("batched lanes", H, B, ker, work, L, False, lanes_form=lanes, plain=ref),
            )), flush=True)


if __name__ == "__main__":
    main()
