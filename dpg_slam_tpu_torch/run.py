"""Multi-session experiment runner — the port of dpg_slam_tpu/run.py.

Replays sessions through the port's engine, one pass per session, with
the pass-boundary reoptimize between them (the dpg_data_runner's
/new_pass + reoptimization_complete handshake):

  python -m dpg_slam_tpu_torch.run --suite gdc --offline --out results/
  python -m dpg_slam_tpu_torch.run --logs pass0.npz pass1.dsl --out results/
  python -m dpg_slam_tpu_torch.run --device cpu --num-beams 128 --max-nodes 64

Takes the JAX runner's flags plus --device (default cuda: with no CUDA
device it raises, it never carries on on the CPU). Prints a JSON summary
with the JAX runner's keys (per-pass keyframes, ATE / RPE where there is
ground truth, node / edge counts, map-layer counts, wall-clock per stage)
plus "device"; with --out, writes summary.json and trajectory.npz as the
JAX runner does, and the logs, checkpoint, render and trace it is asked
for. On the card every clock read follows torch.cuda.synchronize(), so
track_seconds and reoptimize_seconds are the card's wall time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time

import numpy as np
import torch

from dpg_slam_tpu_torch.config import CapacityParams, DpgConfig, DpgParams, PoseGraphParams, ScanParams
from dpg_slam_tpu_torch.engine import DpgSlamEngine
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.io import logs as log_io
from dpg_slam_tpu_torch.io import suites as suites_mod
from dpg_slam_tpu_torch.utils.checkpoint import save_checkpoint
from dpg_slam_tpu_torch.utils.metrics import ate_rmse, relative_pose_error, to_anchor_frame
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["build_config", "synthetic_passes", "run_pass", "parse_args", "run", "main"]


def build_config(args) -> DpgConfig:
    if args.config:
        return DpgConfig.from_json(pathlib.Path(args.config).read_text())
    return DpgConfig(
        scan=ScanParams(num_beams=args.num_beams),
        pose_graph=PoseGraphParams(
            icp_max_points=256 if args.num_beams >= 512 else 64,
            max_loop_closures_per_node=8,
        ),
        dpg=DpgParams(grid_extent_cells=512, occ_grid_resolution=0.1, max_submap_nodes=16),
        capacity=CapacityParams(max_nodes=args.max_nodes, max_edges=args.max_nodes * 10, max_priors=16),
    )


def synthetic_passes(cfg, n_passes: int, scenario: str):
    """Simulated multi-pass sessions of the office world; with box_change
    pass 0 has a box that later vanishes and the last pass adds one."""
    base = dataset.make_office_world()
    wps = dataset.office_loop_waypoints()
    seqs = []
    for p in range(n_passes):
        world = base
        if scenario == "box_change" and n_passes > 1:
            if p == 0:
                world = base.add_box(2.0, 1.5, 1.0, 1.0)
            elif p == n_passes - 1:
                world = base.add_box(-3.0, 1.5, 1.0, 1.0)
        seqs.append(dataset.simulate_sequence(
            world, wps, cfg.scan, step=0.25, seed=100 + p, odom_noise_transl=0.02, odom_noise_rot=0.008,
        ))
    return seqs


def run_pass(eng, seq, timer=None):
    """Feed one session through the engine scan by scan (the node's
    odometry / laser callbacks); returns the keyframes' timestep indices.
    With a StageTimer, records each callback's wall-clock; either way
    each callback is a span of the recorder (utils.profiling)."""
    kf = []
    stage = timer or profiling.span
    for t in range(len(seq.scans)):
        with stage("observe_odometry"):
            eng.observe_odometry(seq.odometry[t])
        with stage("observe_laser"):
            if eng.observe_laser(seq.scans[t]):
                kf.append(t)
    return kf


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    parser.add_argument("--suite", default=None,
                        help="named benchmark suite (gdc | mit) or a path to a .json suite manifest binding "
                             "converted recorded-data logs")
    parser.add_argument("--logs", nargs="*", default=None, help="sequence logs (.npz/.dsl), one per pass")
    parser.add_argument("--offline", action="store_true",
                        help="run each pass through engine.process_sequence instead of the per-scan callback loop")
    parser.add_argument("--scenario", default="box_change", choices=["box_change", "static"])
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--num-beams", type=int, default=1024)
    parser.add_argument("--max-nodes", type=int, default=512)
    parser.add_argument("--config", default=None, help="DpgConfig json file")
    parser.add_argument("--out", default=None, help="output directory")
    parser.add_argument("--render", action="store_true", help="write map PNG (needs matplotlib)")
    parser.add_argument("--save-checkpoint", action="store_true")
    parser.add_argument("--save-logs", action="store_true", help="persist the sessions as .dsl logs")
    parser.add_argument("--profile", action="store_true",
                        help="per-stage wall-clock stats in the summary and the program's spans recorded; with "
                             "--out, also a torch.profiler trace of the pass-boundary reoptimize, spans included, "
                             "under <out>/trace")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    return parser.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dpg_slam_tpu_torch.run: no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def run(args: argparse.Namespace):
    """The runner on parsed arguments; returns (summary, engine)."""
    device = _device(args.device)
    cfg = build_config(args)
    if args.suite:
        suite = suites_mod.load_suite(args.suite)
        cfg = suites_mod.apply_overrides(cfg, suite)
        seqs = [suites_mod.materialize(s, cfg.scan) for s in suite.sessions]
    elif args.logs:
        seqs = [log_io.load_sequence(p) for p in args.logs]
    else:
        seqs = synthetic_passes(cfg, args.passes, args.scenario)

    eng = DpgSlamEngine(cfg, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else None

    def clock() -> float:
        if sync is not None:
            sync()
        return time.perf_counter()

    out_dir = pathlib.Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    timer = profiling.StageTimer(sync) if args.profile else None
    stage = timer or profiling.span

    # --profile records the program's spans: the trace below shows them
    # over the device's operations.
    with profiling.tracing() if args.profile else contextlib.nullcontext():
        summary = {"passes": [], "config_beams": cfg.scan.num_beams}
        node_start = 0
        for p, seq in enumerate(seqs):
            t0 = clock()
            if args.offline:
                with stage("process_sequence"):
                    kf = list(np.flatnonzero(eng.process_sequence(seq.odometry, seq.scans)))
            else:
                kf = run_pass(eng, seq, timer=timer)
            track_s = clock() - t0

            pass_info = {
                "pass": p,
                "scans": len(seq.scans),
                "keyframes": len(kf),
                "track_seconds": round(track_s, 2),
                "track_fps": round(len(seq.scans) / track_s, 1),
            }
            if seq.ground_truth is not None and kf:
                gt = to_anchor_frame(seq.ground_truth[kf])
                traj = eng.trajectory()[node_start:]
                pass_info["ate_m"] = round(ate_rmse(traj, gt), 4)
                pass_info["rpe_m"] = round(relative_pose_error(traj, gt), 4)
            if eng.last_dpg_info is not None:
                pass_info["dpg_coverage"] = round(float(eng.last_dpg_info.coverage), 3)
            summary["passes"].append(pass_info)
            node_start = eng.num_nodes()

            if out_dir and args.save_logs:
                log_io.save_sequence(out_dir / f"pass{p}.dsl", seq)

            if p < len(seqs) - 1:
                trace = contextlib.nullcontext()
                if timer is not None and out_dir and p == 0:
                    trace = profiling.device_trace(out_dir / "trace")
                t0 = clock()
                with trace, stage("reoptimize"):
                    eng.increment_pass()  # the /new_pass + reoptimize handshake
                summary["passes"][-1]["reoptimize_seconds"] = round(clock() - t0, 2)

    if timer is not None:
        summary["profile"] = timer.summary()
    summary["total_nodes"] = eng.num_nodes()
    summary["total_edges"] = int(eng.state.graph.num_edges)
    summary["map_layers"] = {k: int(len(v)) for k, v in eng.map_layers().items()}
    summary["device"] = {"type": device.type,
                         "name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}

    if out_dir:
        np.savez(out_dir / "trajectory.npz", poses=eng.trajectory(), odometry=eng.odom_trajectory())
        (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
        if args.render:
            from dpg_slam_tpu_torch import viz

            summary["render"] = viz.render_session(eng, str(out_dir / "map.png"))
        if args.save_checkpoint:
            save_checkpoint(out_dir / "checkpoint", eng)
            summary["checkpoint"] = str(out_dir / "checkpoint")
    return summary, eng


def main(argv=None) -> int:
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
