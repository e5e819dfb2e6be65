#!/usr/bin/env python3
"""Where the lane-axis LM's bits leave the one-graph solve's, on one NVIDIA
GPU (or the CPU with "cpu").

    python3 tools/lanes_vs_solve_bits.py [cuda|cpu]

Builds chip_smoke.py phase 11e's input (the multipass configuration of
record's pass-0 states, 8 lanes), captures the stacked graph that
batched_increment_pass hands to graph.factor_graph.solve_lanes, and for
each lane compares, to the bit, the lane-axis pieces with the one-graph
ones on the same poses: the whitened residuals and Jacobians, the normal
equations (diagonal, off-diagonal and gradient blocks), the error, the
dense damped matrix; then solve_lanes against solve per lane (poses equal,
largest difference, accepted steps). Prints one JSON line per lane and
one per solve, and the device's name (nvidia-smi's name and power limit
on a card).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from dpg_slam_tpu_torch.graph import factor_graph as fg  # noqa: E402


def captured_lanes(device: str):
    """(poses, graph, node_mask, solve kwargs) of solve_lanes' call in
    batched_increment_pass on the multipass pass-0 states."""
    cfg = cs.multipass_config()
    lanes, _ = cs.multipass_lanes(cfg)
    states, _ = cs.batch_mod.process_sessions_multipass(cfg, [p[:1] for p in lanes], solve_stride=cs.MULTI_STRIDE,
                                                        solve_gn_iterations=cs.MULTI_GN, device=device)
    box, real = {}, fg.solve_lanes

    def capture(poses, g, mask, **kw):
        box["args"] = (poses.clone(), fg.FactorGraph(*(x.clone() for x in g)), mask.clone(), kw)
        return real(poses, g, mask, **kw)

    fg.solve_lanes = capture
    try:
        cs.batch_mod.batched_increment_pass(cfg, cs.clone_states(states))
    finally:
        fg.solve_lanes = real
    return box["args"]


def main() -> None:
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("lanes_vs_solve_bits.py needs a CUDA device (or pass cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        cs._nvcc.build_all([cs.icp_cuda._SRC, cs.schur_cuda._SRC])
    poses, graph, mask, kw = captured_lanes(device)
    S, N = poses.shape[:2]
    E = graph.edge_idx.shape[1]
    rd = kw["robust_delta"]
    eq_l, err_l = fg._assemble_lanes(poses, graph, mask, rd)
    flat = poses.reshape(S * N, 3)
    _, i_idx, j_idx = fg._factor_rows(graph, N)
    er_l, ji_l, jj_l = fg._between_rj(flat[i_idx], flat[j_idx], graph.edge_meas.reshape(-1, 3),
                                      graph.edge_sqrt_info.reshape(-1, 3, 3))
    damping = torch.full((S,), kw["damping_init"], device=poses.device)
    h_l = fg._dense_H(eq_l, graph, damping)
    for s in range(S):
        g = fg.FactorGraph(*(x[s] for x in graph))
        eq, err = fg._assemble(poses[s], g, mask[s], rd)
        er, ji, jj = fg._between_residual_jac(poses[s], g)
        print(json.dumps(dict(
            lane=s, residual=torch.equal(er, er_l.view(S, E, 3)[s]), jacobian_i=torch.equal(ji, ji_l.view(S, E, 3, 3)[s]),
            jacobian_j=torch.equal(jj, jj_l.view(S, E, 3, 3)[s]), diag=torch.equal(eq.diag, eq_l.diag[s]),
            off=torch.equal(eq.off, eq_l.off[s]), rhs=torch.equal(eq.rhs, eq_l.rhs[s]),
            error=torch.equal(err, err_l[s]), total_error=torch.equal(fg.total_error(poses[s], g, rd), err_l[s]),
            dense_H=torch.equal(fg._dense_H(eq, g, damping[s]), h_l[s]),
        )), flush=True)
    solved, _ = fg.solve_lanes(poses, graph, mask, **kw)
    for s in range(S):
        g = fg.FactorGraph(*(x[s] for x in graph))
        one, stats = fg.solve(poses[s], g, mask[s], **kw)
        print(json.dumps(dict(lane=s, solve_equal=torch.equal(one, solved[s]),
                              max_pose_diff=cs.pose_diff(one, solved[s]), accepted=stats.iterations)), flush=True)


if __name__ == "__main__":
    main()
