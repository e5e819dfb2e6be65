#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpg_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written ICP kernel (K1, csrc/icp_kernel.cu) with nvcc,
holds it against its plain PyTorch version at the main path's shapes, then
drives the port's main path through the engine API a user calls, at the
full-width bench configuration of the committed fixtures (1024 beams,
256 ICP points, K = 8, 30 ICP iterations):

  0 context    card name and power limit (nvidia-smi), torch / CUDA versions
  1 build      nvcc build of K1
  2 kernel     K1 vs plain on a keyframe's 9-pair batch, the ~1.7k-pair
               compacted reoptimize sweep, and a Censi-mode masked batch
  3 keyframe   bench_assets/keyframe + its 69 continuation scans, on the
               card and on the CPU (plain versions); kf/s
  4 ate        the office loop simulated at full width, tracked on the card
  5 reoptimize bench_assets/session: increment_pass() on the card and on
               the CPU; pairs/s

Each phase prints one JSON line; any failed check raises, so the exit code
is non-zero. The last lines are the kernels' record, the card's
nvidia-smi line and {"ok": true, "device": {...}}. Without a CUDA device
it raises before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

import dpg_slam_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
from dpg_slam_tpu_torch import engine as eng_mod
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.ops import icp, icp_cuda
from dpg_slam_tpu_torch.utils.checkpoint import load_checkpoint
from dpg_slam_tpu_torch.utils.metrics import ate_rmse, to_anchor_frame

ROOT = pathlib.Path(__file__).resolve().parent
ASSETS = ROOT / "bench_assets"
DEVICE = "cuda"

# Kernel vs plain (tests/test_icp_pallas.py's tolerances).
TRANSFORM_ATOL = 5e-4
FITNESS_ATOL = 1e-4
COV_RTOL, COV_ATOL = 0.05, 1e-7
CONVERGED_AGREE = 0.999
GATE_REL = 1e-3
# Card vs CPU engine runs.
POSE_TOL = 1e-2
EDGE_REL = 0.005


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events), after
    one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --- phase 2 helpers ---------------------------------------------------------

def keyframe_batch(cfg: DpgConfig):
    """A (1+K)-pair ICP batch as the engine assembles it on the
    bench_assets/keyframe continuation: of all its keyframes, the one with
    the most live loop-closure candidates."""
    eng = load_checkpoint(ASSETS / "keyframe", DEVICE)
    with np.load(ASSETS / "keyframe" / "continuation.npz") as cont:
        scans, odom = cont["scans"], cont["odometry"]
    best, best_live = None, -1
    for t in range(len(scans)):
        eng.observe_odometry(odom[t])
        if eng_mod._should_process(cfg, eng.state):
            ranges = torch.as_tensor(scans[t], device=DEVICE)
            _, inp, _, tgt_valid, *_ = eng_mod._keyframe_frontend_pre(cfg, eng.state, ranges)
            if int(tgt_valid.sum()) > best_live:
                best_live = int(tgt_valid.sum())
                best = (inp.src, inp.src_mask, inp.tgt, inp.tgt_mask, inp.seeds), inp.tgt_normals, inp.gate
            eng.observe_laser(scans[t])
    if best is None:
        raise RuntimeError("no keyframe in the continuation scans")
    return best


def reoptimize_batch(cfg: DpgConfig):
    """The compacted reoptimize sweep of bench_assets/session."""
    state = load_checkpoint(ASSETS / "session", DEVICE).state
    n = int(state.num_nodes)
    nb = eng_mod.DpgSlamEngine(cfg, DEVICE)._solve_bucket(n)
    idx, val, n_live = eng_mod._reoptimize_compaction_host(
        cfg, state.poses[:nb].cpu().numpy(), state.pass_ids[:nb].cpu().numpy(), n, nb
    )
    sub = state._replace(**{f: getattr(state, f)[:nb] for f in eng_mod._NODE_FIELDS})
    _, args, kwargs, _ = eng_mod._reoptimize_icp_inputs(
        cfg, sub, torch.as_tensor(idx, device=DEVICE), torch.as_tensor(val, device=DEVICE)
    )
    return args[:5], kwargs["tgt_normals"], kwargs["gate_multiplier"], n_live


def compare(name, ker, ref, pg, seeds, gate):
    """Hold K1's result against the plain version's; raise on a miss."""
    t_err = (ker.transform - ref.transform).abs().max().item()
    f_err = (ker.fitness - ref.fitness).abs().max().item()
    agree = ker.converged == ref.converged
    B = agree.numel()
    frac = agree.float().mean().item()
    # Disagreements must sit at a gate (fitness, overlap or seed deviation).
    bad = []
    for i in torch.nonzero(~agree).flatten().tolist():
        near = False
        budget = gate[i].item() * pg.icp_max_correspondence_distance
        for r in (ker, ref):
            dev = torch.linalg.norm(r.transform[i, :2] - seeds[i, :2]).item()
            near |= abs(r.fitness[i].item() - 0.25) <= GATE_REL * 0.25
            near |= abs(r.overlap[i].item() - pg.icp_min_overlap) <= GATE_REL * pg.icp_min_overlap
            near |= abs(dev - budget) <= GATE_REL * budget
        bad += [] if near else [i]
    both = agree
    cov_ok = torch.allclose(ker.covariance[both], ref.covariance[both], rtol=COV_RTOL, atol=COV_ATOL)
    cov_err = (ker.covariance[both] - ref.covariance[both]).abs().max().item() if both.any() else 0.0
    emit(
        "kernel_check", batch=name, pairs=B, transform_max_abs_err=t_err,
        fitness_max_abs_err=f_err, converged_agree=frac, cov_max_abs_err=cov_err,
        converged=int(ker.converged.sum()),
    )
    if t_err > TRANSFORM_ATOL or f_err > FITNESS_ATOL or not cov_ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    if frac < CONVERGED_AGREE or bad:
        raise AssertionError(f"{name}: converged flags differ away from the gates at pairs {bad}")
    return t_err


def kernel_phase(cfg: DpgConfig):
    """Phase 2: K1 against the plain version at the main path's shapes."""
    pg = cfg.pose_graph
    kf_args, kf_normals, kf_gate = keyframe_batch(cfg)
    ro_args, ro_normals, ro_gate, n_live = reoptimize_batch(cfg)
    censi_pg = dataclasses.replace(pg, icp_covariance_mode="censi")
    src, src_mask, tgt, tgt_mask, seeds = kf_args
    masked = (src, src_mask & (torch.arange(src.shape[1], device=DEVICE) % 7 != 0), tgt,
              tgt_mask & (torch.arange(tgt.shape[1], device=DEVICE) % 5 != 0), seeds)
    cases = [
        ("keyframe", kf_args, kf_normals, kf_gate, pg),
        ("reoptimize", ro_args, ro_normals, ro_gate, pg),
        ("censi_masked", masked, kf_normals, kf_gate, censi_pg),
    ]
    worst, times = 0.0, {}
    for name, args, normals, gate, p in cases:
        kw = dict(tgt_normals=normals, gate_multiplier=gate, min_correspondences=10,
                  fitness_threshold=0.25, min_overlap=p.icp_min_overlap,
                  sensor_noise_std=p.icp_sensor_noise_std)
        ker = icp_cuda.icp_align_cuda(*args, p, **kw)
        torch.cuda.synchronize()
        ref = icp.icp_align_plain(*args, p, **kw)
        worst = max(worst, compare(name, ker, ref, p, args[4], gate))
        if name == "censi_masked":
            continue
        reps = 20 if name == "keyframe" else 3
        ms = cuda_ms(lambda: icp_cuda.icp_align_cuda(*args, p, **kw), reps)
        plain_ms = cuda_ms(lambda: icp.icp_align_plain(*args, p, **kw), reps)
        planes, kseeds = icp_cuda.pack(*args[:4], normals, args[4], gate)
        kernel_only_ms = cuda_ms(lambda: icp_cuda.run_kernel(planes, kseeds, p, False), reps)
        times[name] = dict(pairs=int(args[0].shape[0]), ms=ms, plain_ms=plain_ms, kernel_only_ms=kernel_only_ms)
        emit("kernel_time", batch=name, **times[name])
    return worst, times, n_live


# --- phases 3-5 ---------------------------------------------------------------

def run_keyframes(device: str):
    eng = load_checkpoint(ASSETS / "keyframe", device)
    with np.load(ASSETS / "keyframe" / "continuation.npz") as cont:
        scans, odom = cont["scans"], cont["odometry"]
    kfs = []
    t0 = time.perf_counter()
    for t in range(len(scans)):
        eng.observe_odometry(odom[t])
        if eng.observe_laser(scans[t]):
            kfs.append(t)
    if device == "cuda":
        torch.cuda.synchronize()
    return eng, kfs, time.perf_counter() - t0


def check_same_run(name, gpu, cpu):
    """Card run vs CPU run of the same engine calls."""
    g_traj, c_traj = gpu.trajectory(), cpu.trajectory()
    if g_traj.shape != c_traj.shape or not np.isfinite(g_traj).all():
        raise AssertionError(f"{name}: trajectories differ in shape or are not finite")
    d = np.abs(g_traj - c_traj)
    d[:, 2] = np.abs(np.angle(np.exp(1j * (g_traj[:, 2].astype(np.float64) - c_traj[:, 2]))))
    ge, ce = int(gpu.state.graph.num_edges), int(cpu.state.graph.num_edges)
    edge_rel = abs(ge - ce) / max(ce, 1)
    out = dict(max_pose_diff_m=float(d[:, :2].max()), max_pose_diff_rad=float(d[:, 2].max()),
               edges_gpu=ge, edges_cpu=ce)
    if d.max() > POSE_TOL or edge_rel > EDGE_REL:
        raise AssertionError(f"{name}: card and CPU runs disagree: {out}")
    return out


def keyframe_phase():
    run_keyframes(DEVICE)  # warm-up: cuSOLVER / allocator first use
    before = icp_cuda.LAUNCHES
    gpu, kfs, secs = run_keyframes(DEVICE)
    launches = icp_cuda.LAUNCHES - before
    cpu, kfs_cpu, cpu_secs = run_keyframes("cpu")
    if kfs != kfs_cpu:
        raise AssertionError(f"keyframe indices differ: {kfs} vs {kfs_cpu}")
    if launches < len(kfs):
        raise AssertionError(f"K1 launched {launches} times for {len(kfs)} keyframes")
    diff = check_same_run("keyframe", gpu, cpu)
    emit("keyframe", keyframes=len(kfs), seconds=secs, kf_per_s=len(kfs) / secs,
         cpu_seconds=cpu_secs, launches=launches, **diff)
    return len(kfs) / secs


def ate_phase(cfg: DpgConfig):
    seq = dataset.simulate_sequence(
        dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan,
        step=0.25, seed=1, odom_noise_transl=0.02, odom_noise_rot=0.008,
    )
    eng = eng_mod.DpgSlamEngine(cfg, DEVICE)
    kfs = []
    for t in range(len(seq.scans)):
        eng.observe_odometry(seq.odometry[t])
        if eng.observe_laser(seq.scans[t]):
            kfs.append(t)
    gt = to_anchor_frame(seq.ground_truth[kfs])
    ate = ate_rmse(eng.trajectory(), gt)
    odo = ate_rmse(to_anchor_frame(eng.odom_trajectory()), gt)
    emit("ate", scans=len(seq.scans), keyframes=len(kfs), ate_m=ate, odom_ate_m=odo)
    if not (ate < 0.25 and ate <= odo + 0.05):
        raise AssertionError(f"ATE {ate} m (odometry {odo} m) outside the bounds")
    return ate


def reoptimize_phase(n_live: int):
    def run(device):
        eng = load_checkpoint(ASSETS / "session", device)
        eng._dpg_enabled = False
        t0 = time.perf_counter()
        eng.increment_pass()
        if device == "cuda":
            torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    before = icp_cuda.LAUNCHES
    gpu, secs = run(DEVICE)
    launches = icp_cuda.LAUNCHES - before
    cpu, cpu_secs = run("cpu")
    if launches < 1:
        raise AssertionError("the reoptimize did not launch K1")
    diff = check_same_run("reoptimize", gpu, cpu)
    emit("reoptimize", nodes=gpu.num_nodes(), live_pairs=n_live, seconds=secs,
         pairs_per_s=n_live / secs, cpu_seconds=cpu_secs, launches=launches, **diff)
    return n_live / secs


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("context", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    icp_cuda.build()
    icp_cuda._load()
    emit("build", seconds=time.perf_counter() - t0)

    cfg = DpgConfig.from_json((ASSETS / "keyframe" / "config.json").read_text())
    worst, times, n_live = kernel_phase(cfg)

    # The main path: counts start at 0 here and are read after phase 5.
    icp_cuda.LAUNCHES = 0
    keyframe_phase()
    ate_phase(cfg)
    reoptimize_phase(n_live)
    launches = icp_cuda.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched K1")

    ro = times["reoptimize"]
    print(json.dumps({"kernels": [{
        "name": "icp_point_to_line",
        "route": "cuda",
        "source": "dpg_slam_tpu_torch/csrc/icp_kernel.cu",
        "replaces": "dpg_slam_tpu/ops/icp_pallas.py:170",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ro["ms"],
        "plain_ms": ro["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
