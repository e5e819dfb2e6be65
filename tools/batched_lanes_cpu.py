#!/usr/bin/env python3
"""Lane ATE of the session-batched mode on the CPU, JAX package and port,
at chip_smoke.py phase 9's configuration (16 simulated sessions of 3
office laps, edge capacity 1,536, "lanes_chol", a solve every 32
keyframes, GN 5), both with their plain ICP.

    JAX_PLATFORMS=cpu python3 tools/batched_lanes_cpu.py [jax|port]...

Prints, per package, the keyframe counts, each lane's ATE (m), their mean
and largest, and the seconds the run took. Takes minutes per package (the
plain ICP of 144 pairs a step on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
STRIDE, GN, MAX_EDGES, SESSIONS, LAPS = 32, 5, 1536, 16, 3


def sessions(dataset, scan_params):
    wps = dataset.office_loop_waypoints()
    wps = np.vstack([wps] + [wps[1:]] * (LAPS - 1))
    return [dataset.simulate_sequence(dataset.make_office_world(), wps, scan_params, step=0.25, seed=11 + i,
                                      odom_noise_transl=0.02, odom_noise_rot=0.008) for i in range(SESSIONS)]


def report(name, cfg, batch, seqs, lane_poses, counts, secs, metrics):
    ates = []
    for i, s in enumerate(seqs):
        kf = np.nonzero(batch.keyframe_schedule(cfg, s.odometry))[0][: counts[i]]
        ates.append(float(metrics.ate_rmse(lane_poses(i)[: counts[i]], metrics.to_anchor_frame(s.ground_truth[kf]))))
    print(json.dumps({"package": name, "keyframes": counts, "lane_ates_m": ates, "mean_lane_ate_m": float(np.mean(ates)),
                      "max_lane_ate_m": max(ates), "seconds": secs}), flush=True)


def run_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dpg_slam_tpu import batch
    from dpg_slam_tpu.config import DpgConfig
    from dpg_slam_tpu.io import dataset
    from dpg_slam_tpu.utils import metrics

    cfg = DpgConfig.from_json((ROOT / "bench_assets" / "keyframe" / "config.json").read_text())
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_edges=MAX_EDGES))
    seqs = sessions(dataset, cfg.scan)
    t0 = time.perf_counter()
    st, counts = batch.process_sessions_batched(cfg, [(s.odometry, s.scans) for s in seqs], solve_method="lanes_chol",
                                                solve_stride=STRIDE, solve_gn_iterations=GN, use_kernel=False)
    poses = np.asarray(st.poses)
    report("jax", cfg, batch, seqs, lambda i: poses[i], counts, time.perf_counter() - t0, metrics)


def run_port():
    from dpg_slam_tpu_torch import batch
    from dpg_slam_tpu_torch.config import DpgConfig
    from dpg_slam_tpu_torch.io import dataset
    from dpg_slam_tpu_torch.utils import metrics

    cfg = DpgConfig.from_json((ROOT / "bench_assets" / "keyframe" / "config.json").read_text())
    cfg = cfg.replace(capacity=dataclasses.replace(cfg.capacity, max_edges=MAX_EDGES))
    seqs = sessions(dataset, cfg.scan)
    t0 = time.perf_counter()
    st, counts = batch.process_sessions_batched(cfg, [(s.odometry, s.scans) for s in seqs], solve_method="lanes_chol",
                                                solve_stride=STRIDE, solve_gn_iterations=GN, device="cpu")
    poses = st.poses.numpy()
    report("port", cfg, batch, seqs, lambda i: poses[i], counts, time.perf_counter() - t0, metrics)


if __name__ == "__main__":
    for which in sys.argv[1:] or ["jax", "port"]:
        {"jax": run_jax, "port": run_port}[which]()
