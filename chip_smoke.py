#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpg_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels, the ICP loop (K1, csrc/icp_kernel.cu) and
the batched SPD solve (K2, csrc/spd_solve_kernel.cu), with one nvcc each,
started together; holds each against its plain PyTorch version at the
shapes its paths give it; then drives the port's paths through the entry
points a user calls, at the full-width bench configuration of the
committed fixtures (1024 beams, 256 ICP points, K = 8, 30 ICP iterations,
256 node slots):

  0 context      card name and power limit (nvidia-smi), torch / CUDA versions
  1 build        nvcc builds of K1 and K2
  2 kernel       K1 vs plain on a keyframe's 9-pair batch, the ~1.7k-pair
                 compacted reoptimize sweep, a Censi-mode masked batch, 8
                 pairs of 256 sources against 2,048 targets (the DPG local
                 registration's shape) and the keyframe batch tiled 16 times
                 (batched mode's shape at 16 sessions); on each, K1's launch
                 plan (cluster size C), its time at every C the shape
                 admits, and its rows at the planned C against C = 1
  2b k2_kernel   K2 vs plain and vs torch.linalg's Cholesky on the inputs
                 its three paths give it (captured from those paths), with
                 its launch plan; both factorization layouts (one CTA per
                 system, many CTAs per system) timed, and the factors they
                 leave compared
  3 keyframe     bench_assets/keyframe + its 69 continuation scans, on the
                 card and on the CPU (plain versions); kf/s
  4 ate          the office loop simulated at full width, tracked on the card
  5 reoptimize   bench_assets/session: increment_pass() on the card and on
                 the CPU; pairs/s
  6 dense_pallas phases 3 and 5 with solve_method = "dense_pallas" (K2),
                 against the card's "dense" runs
  7 schur        distributed_reoptimize on 4 shards of bench_assets/session,
                 Schur elimination through K2, against torch.linalg's
                 elimination and the single-card reoptimize; and an engine
                 built with the mesh
  8 offline      process_sequence over phase 3's scans, plain and pipelined,
                 with the default solve and "dense_pallas"; kf/s beside
                 phase 3's, keyframes and poses against phase 3's run
  9 batched      process_sessions_batched at the JAX package's configuration
                 of record (16 simulated sessions of 3 office laps, K = 8,
                 "lanes_chol", a solve every 32 keyframes): aggregate kf/s
                 (median of 3 after a warm run), lane ATE, K1's launches and
                 batch sizes, host syncs inside the step loop (must be 0);
                 9b two one-lap lanes against process_sequence; 9c K1 on a
                 captured 144-pair step against plain, and K2 beside
                 torch.linalg on a captured (16, 384, 1) lanes system
 10 dpg          DPG change detection at the session config (1024 beams,
                 a 1024² window at 0.05 m, M = 32, C = 5, local
                 registration on 2,048 targets): 10a one execute_dpg on
                 bench_assets/session on the card and on the CPU, compared,
                 timed (median of 20 calls after a warm one), its host
                 syncs counted (must be 0) and its K1 launches (1); 10b K1
                 on the step's captured 5 x (256 vs 2,048) batch against
                 plain, with its launch plan and layouts; 10c the two-pass
                 box scene of tests/test_dpg.py at full width, online, with
                 that test's bars and the JAX package's values beside; 10d
                 process_sequence on the session state without and with
                 DPG (bench.py's bench_dpg part b)

Each path phase (3-10) runs with the kernels' launch counts set to 0 just
before it and read just after. Each phase prints one JSON line; any failed
check raises, so the exit code is non-zero. The last lines are the
kernels' record, the card's nvidia-smi line and {"ok": true, "device":
{...}}. Without a CUDA device it raises before doing anything.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

import dpg_slam_tpu_torch  # noqa: F401  (sets the float32 matmul policy)
from dpg_slam_tpu_torch import batch as batch_mod
from dpg_slam_tpu_torch import engine as eng_mod
from dpg_slam_tpu_torch import scan
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.dpg import change_detection
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.ops import _nvcc, icp, icp_cuda, schur, schur_cuda
from dpg_slam_tpu_torch.parallel import distributed_reoptimize, make_mesh
from dpg_slam_tpu_torch.parallel.distributed import separator_cap
from dpg_slam_tpu_torch.parallel.partition import spatial_blocks
from dpg_slam_tpu_torch.parallel.schur import schur_solve
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
# K2 vs plain: max |X_k - X_p| / max |X_p| within 1e-4 (two blocked
# Cholesky orders in float32), or, on a system whose conditioning spreads
# any two float32 factorizations further apart, within twice the distance
# between torch.linalg's Cholesky and the plain version on the same input;
# and K2's relative residual |H X - B| / |B| within 1e-5 or twice the
# library's.
K2_REL = 1e-4
K2_RESIDUAL = 1e-5
# Schur reoptimize: K2 vs torch.linalg elimination (the rel_tol stop may
# take one step more or fewer at full size; tests/test_schur.py holds 1e-4
# at N = 32) and vs the single-card dense reoptimize
# (tests/test_distributed.py's 2e-2).
SCHUR_ELIM_TOL = 1e-3
SCHUR_SINGLE_TOL = 2e-2
SHARDS = 4
# Offline: the pipelined schedule within 0.2 m of the plain one
# (tests/test_engine.py::test_pipelined_sequence_close_to_online).
PIPELINED_TOL = 0.2
# Batched mode at the JAX package's configuration of record (bench.py's
# BATCHED_* and build_batched_sessions): 16 sessions of 3 office laps at
# 0.25 m steps, seeds 11-26, edge capacity 1,536, "lanes_chol", a solve
# every 32 keyframes, 5 LM steps; the median of BATCH_REPEATS timed runs
# after a warm one. Lane ATE below tests/test_batch.py's 0.25 m; lanes
# against process_sequence within its 2e-3 (tests/test_batch.py).
BATCH_SESSIONS, BATCH_LAPS, BATCH_STEP, BATCH_SEED0 = 16, 3, 0.25, 11
BATCH_METHOD, BATCH_STRIDE, BATCH_GN, BATCH_MAX_EDGES = "lanes_chol", 32, 5, 1536
BATCH_REPEATS = 3
LANE_ATE_MAX = 0.25
LANE_POSE_TOL = 2e-3
SPREAD_RUNS = 3
# DPG (phase 10). Card against CPU on one step: at most 0.1 % of the live
# label entries and of the sector entries differ (atan2 and the local
# registration's sums differ in the last bits), node_active and the
# contributor count equal, the added / removed counts within max(2, 1 %),
# coverage within 1e-3. The box scene's bars are tests/test_dpg.py's.
DPG_ENTRY_FRAC = 1e-3
DPG_COUNT_ABS, DPG_COUNT_REL = 2, 0.01
DPG_COVERAGE_ATOL = 1e-3
DPG_REPEATS = 20
DPG_OFFLINE_SCANS = 56
# The JAX package on this scene and config (jax 0.9.0 on a CPU): both
# passes through observe_laser, DPG on; a comparison, not a gate.
DPG_SCENE_JAX = dict(keyframes=[38, 37], added=1298, removed=517, removed_near_frac=0.857,
                     pass0_sectors_off=35, last_info=dict(num_added=171, num_removed=0, coverage=0.954,
                                                          num_contributors=18))
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the
# tensor cores (an FMA counted as two flops) and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 instruction rate of an H100 SXM: 128 lanes x 132 SMs x 1.98 GHz
# (boost clock). K1's distance arithmetic has no FMA (its d2 helper
# forbids contraction), so each of its operations takes one instruction.
PEAK_FP32_INSTR = 128 * 132 * 1.98e9

K1, K2 = "icp_point_to_line", "spd_solve"
# Launches on the paths (phases 3-7), summed over the phases.
LAUNCHED = {K1: 0, K2: 0}


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


def counted(run):
    """Run one path with both kernels' counts at 0; add what it launched to
    LAUNCHED and return (result, {kernel: launches})."""
    icp_cuda.LAUNCHES = 0
    schur_cuda.LAUNCHES = 0
    out = run()
    got = {K1: icp_cuda.LAUNCHES, K2: schur_cuda.LAUNCHES}
    for k, v in got.items():
        LAUNCHED[k] += v
    return out, got


def bound(flops: float, nbytes: float, rate: float = PEAK_FP32) -> tuple[float, str]:
    """(least milliseconds, what bounds it) on the card's published peaks:
    `flops` at `rate` operations per second, `nbytes` at HBM bandwidth."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def k1_bound(args, out, pg):
    """K1's least time on this batch: per pair, (iterations + 1 final pass)
    x valid sources x valid targets point pairs, each at 7 operations (the
    distance once: 2 sub, 2 mul, add; a compare against the source's
    running min; a min into the target's col-min, with reciprocal
    matching; 6 without) at the FP32 instruction rate; bytes: the 3 source
    and 4 target planes, the seeds and the 24-float output rows read or
    written once."""
    src, src_mask, tgt, tgt_mask = args[:4]
    B, Ps = src_mask.shape
    Pt = tgt_mask.shape[1]
    passes = out[:, 11].double() + 1.0
    pairs = src_mask.sum(1).double() * tgt_mask.sum(1).double()
    per = 6 + (1 if pg.icp_use_reciprocal_correspondences else 0)
    ops = float((passes * pairs).sum()) * per
    return bound(ops, 4.0 * (3 * B * Ps + 4 * B * Pt + 4 * B + 24 * B), PEAK_FP32_INSTR)


def local_reg_batch(B: int = 8, Ps: int = 256, Pt: int = 2048, seed: int = 7):
    """B pairs at the DPG local registration's shape: Pt target points on
    the walls of an 8 x 6 m room (2 mm noise), and Ps of them seen from a
    pose within +-0.3 (m, rad) as the source, with that pose's inverse
    perturbed by up to 0.05 as the seed. Made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 4, (B, Pt))
    side = rng.integers(0, 4, (B, Pt))
    x = np.where(side < 2, t * 2 - 4, np.where(side == 2, -4.0, 4.0))
    y = np.where(side == 0, -3.0, np.where(side == 1, 3.0, t * 1.5 - 3))
    tgt = np.stack([x, y], -1) + rng.normal(0, 0.002, (B, Pt, 2))
    pose = rng.uniform(-0.3, 0.3, (B, 3))
    pick = np.stack([rng.choice(Pt, Ps, replace=False) for _ in range(B)])
    c, s = np.cos(pose[:, 2]), np.sin(pose[:, 2])
    d = np.take_along_axis(tgt, pick[..., None], 1) - pose[:, None, :2]
    src = np.stack([c[:, None] * d[..., 0] + s[:, None] * d[..., 1],
                    -s[:, None] * d[..., 0] + c[:, None] * d[..., 1]], -1)
    seeds = pose + rng.uniform(-0.05, 0.05, (B, 3))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=DEVICE)  # noqa: E731
    tgt_t = f32(tgt)
    tgt_mask = torch.ones((B, Pt), dtype=torch.bool, device=DEVICE)
    args = (f32(src), torch.ones((B, Ps), dtype=torch.bool, device=DEVICE), tgt_t, tgt_mask, f32(seeds))
    gate = torch.ones(B, device=DEVICE)
    return args, icp.estimate_normals(tgt_t, tgt_mask), gate


def tie_count(packed, rows, b: int, gate: float) -> int:
    """The most targets tied exactly at one source's row-min inside `gate`
    in pair b at its output row's transform (d2 formed as K1 forms it,
    each product and sum rounded apart; cos and sin from torch)."""
    src_planes, tgt_planes, _ = packed
    tx, ty, th = rows[b, 0], rows[b, 1], rows[b, 2]
    c, s = torch.cos(th), torch.sin(th)
    sx, sy = src_planes[0, b], src_planes[1, b]
    mx, my = (c * sx - s * sy) + tx, (s * sx + c * sy) + ty
    dx = mx[:, None] - tgt_planes[0, b][None]
    dy = my[:, None] - tgt_planes[1, b][None]
    d2 = dx * dx + dy * dy
    tied = (d2 == d2.min(1, keepdim=True).values) & (d2 <= gate * gate)
    return int(tied.sum(1).max())


def layouts(name, packed, pg, censi: bool, reps: int):
    """K1's launch plan on this batch, its kernel-alone time at every
    cluster size the shape admits, and the largest difference between the
    rows of C = 1 and of the planned C; a differing pair is printed with
    its tie count and must show three or more tied targets."""
    _, B, Ps = packed[0].shape
    Pt = packed[1].shape[2]
    plan = icp_cuda.launch_plan(B, Ps, Pt, torch.cuda.get_device_properties(0).multi_processor_count)
    sizes = [C for C in icp_cuda.CLUSTERS if C == 1 or Ps <= 256]
    rows = {C: icp_cuda.run_kernel(*packed, pg, censi, cluster=C) for C in sizes}
    torch.cuda.synchronize()
    diff = (rows[plan] - rows[1]).abs().amax(1)
    for b in torch.nonzero(diff).flatten().tolist():
        ties = tie_count(packed, rows[1], b, pg.icp_max_correspondence_distance)
        emit("k1_layout_differs", batch=name, pair=b, ties=ties, row_c1=rows[1][b].tolist(),
             row_planned=rows[plan][b].tolist())
        if ties < 3:
            raise AssertionError(f"{name}: pair {b} differs between C = 1 and C = {plan} without a three-way tie")
    out = dict(plan=plan, rows_max_abs_diff=diff.max().item(),
               kernel_ms_by_cluster={C: cuda_ms(lambda: icp_cuda.run_kernel(*packed, pg, censi, cluster=C), reps)
                                     for C in sizes})
    emit("k1_layouts", batch=name, pairs=B, sources=Ps, targets=Pt, **out)
    return out


def kernel_phase(cfg: DpgConfig):
    """Phase 2: K1 against the plain version at the main path's shapes."""
    pg = cfg.pose_graph
    kf_args, kf_normals, kf_gate = keyframe_batch(cfg)
    ro_args, ro_normals, ro_gate, n_live = reoptimize_batch(cfg)
    censi_pg = dataclasses.replace(pg, icp_covariance_mode="censi")
    src, src_mask, tgt, tgt_mask, seeds = kf_args
    masked = (src, src_mask & (torch.arange(src.shape[1], device=DEVICE) % 7 != 0), tgt,
              tgt_mask & (torch.arange(tgt.shape[1], device=DEVICE) % 5 != 0), seeds)
    lr_args, lr_normals, lr_gate = local_reg_batch()
    x16 = tuple(t.repeat(16, *([1] * (t.ndim - 1))) for t in kf_args)
    cases = [
        ("keyframe", kf_args, kf_normals, kf_gate, pg),
        ("reoptimize", ro_args, ro_normals, ro_gate, pg),
        ("censi_masked", masked, kf_normals, kf_gate, censi_pg),
        ("local_reg_256_2048", lr_args, lr_normals, lr_gate, pg),
        ("keyframe_x16", x16, kf_normals.repeat(16, 1, 1), kf_gate.repeat(16), pg),
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
        reps = 20 if name in ("keyframe", "censi_masked") else 3
        packed = icp_cuda.pack(*args[:4], normals, args[4], gate)
        lay = layouts(name, packed, p, icp.is_censi_mode(p), max(reps, 10))
        if name == "censi_masked":
            continue
        ms = cuda_ms(lambda: icp_cuda.icp_align_cuda(*args, p, **kw), reps)
        plain_ms = cuda_ms(lambda: icp.icp_align_plain(*args, p, **kw), reps)
        kernel_only_ms = cuda_ms(lambda: icp_cuda.run_kernel(*packed, p, False), reps)
        bound_ms, bound_by = k1_bound(args, icp_cuda.run_kernel(*packed, p, False), p)
        times[name] = dict(pairs=int(args[0].shape[0]), sources=int(args[0].shape[1]), targets=int(args[2].shape[1]),
                           ms=ms, plain_ms=plain_ms, kernel_only_ms=kernel_only_ms, bound_ms=bound_ms,
                           bound_by=bound_by, **lay)
        emit("kernel_time", batch=name, **times[name])
    return worst, times, n_live


# --- phases 3-5 ---------------------------------------------------------------

def run_keyframes(device: str, solve_method: str | None = None):
    eng = load_checkpoint(ASSETS / "keyframe", device)
    if solve_method is not None:
        eng.solve_method = solve_method
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
    (gpu, kfs, secs), got = counted(lambda: run_keyframes(DEVICE))
    launches = got[K1]
    cpu, kfs_cpu, cpu_secs = run_keyframes("cpu")
    if kfs != kfs_cpu:
        raise AssertionError(f"keyframe indices differ: {kfs} vs {kfs_cpu}")
    if launches < len(kfs):
        raise AssertionError(f"K1 launched {launches} times for {len(kfs)} keyframes")
    diff = check_same_run("keyframe", gpu, cpu)
    emit("keyframe", keyframes=len(kfs), seconds=secs, kf_per_s=len(kfs) / secs,
         cpu_seconds=cpu_secs, launches=launches, **diff)
    return gpu, kfs, secs


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


def run_reoptimize(device, solve_method: str | None = None):
    eng = load_checkpoint(ASSETS / "session", device)
    if solve_method is not None:
        eng.solve_method = solve_method
    t0 = time.perf_counter()
    eng.increment_pass()
    if device == "cuda":
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def reoptimize_phase(n_live: int):
    (gpu, secs), got = counted(lambda: run_reoptimize(DEVICE))
    launches = got[K1]
    cpu, cpu_secs = run_reoptimize("cpu")
    if launches < 1:
        raise AssertionError("the reoptimize did not launch K1")
    diff = check_same_run("reoptimize", gpu, cpu)
    emit("reoptimize", nodes=gpu.num_nodes(), live_pairs=n_live, seconds=secs,
         pairs_per_s=n_live / secs, cpu_seconds=cpu_secs, launches=launches, **diff)
    return gpu, secs


# --- phase 2b: K2 on its paths' inputs ----------------------------------------

class _Captured(Exception):
    pass


def capture_spd_input(run):
    """(H, B) of the first ops.schur.spd_solve call that `run` makes, as
    (S, n, n) and (S, n, m); the run is stopped there."""
    box = {}
    real = schur.spd_solve

    def record(H, B):
        box["args"] = (H.detach().clone(), B.detach().clone())
        raise _Captured

    schur.spd_solve = record
    try:
        run()
    except _Captured:
        pass
    finally:
        schur.spd_solve = real
    if "args" not in box:
        raise AssertionError("the path never reached ops.schur.spd_solve")
    H, B = box["args"]
    if H.ndim == 2:
        H, B = H[None], B[None]
    return H.contiguous(), B.contiguous()


def session_schur(pallas: bool):
    eng = load_checkpoint(ASSETS / "session", DEVICE)
    return distributed_reoptimize(make_mesh(SHARDS), eng.config, eng.state, solver="schur",
                                  pallas_elimination=pallas)


def k2_inputs():
    """The inputs K2 gets on its paths: the dense_pallas keyframe solve
    (bucket 64), the dense_pallas reoptimize (bucket 256) and the four
    shards of one Schur iteration on bench_assets/session."""
    return {
        "keyframe_dense": capture_spd_input(lambda: run_keyframes(DEVICE, "dense_pallas")),
        "reoptimize_dense": capture_spd_input(lambda: run_reoptimize(DEVICE, "dense_pallas")),
        "schur_4_shards": capture_spd_input(lambda: session_schur(True)),
    }


def rel_residual(H, X, B):
    return ((H @ X - B).abs().amax() / B.abs().amax()).item()


def k2_kernel_phase():
    """Phase 2b: K2 against the plain version and torch.linalg's Cholesky
    (timed as a yardstick only) at its paths' shapes."""
    out = {}
    for name, (H, B) in k2_inputs().items():
        S, n, _ = H.shape
        m = B.shape[2]
        ker = schur.spd_solve(H, B)
        torch.cuda.synchronize()
        ref = schur.spd_solve_plain(H, B)
        abs_err = (ker - ref).abs().max().item()
        rel_err = abs_err / ref.abs().max().item()
        X = torch.empty_like(B)
        work = torch.empty_like(H)
        # The two factorization layouts on this input: the factors they
        # leave in the workspace (the same to the bit by design), and
        # their kernel-alone times.
        factors = {}
        for layout in ("single", "multi"):
            factors[layout] = torch.empty_like(H)
            schur_cuda.run_kernel(H, B, torch.empty_like(B), factors[layout], layout)
        torch.cuda.synchronize()
        factor_diff = (factors["multi"].tril() - factors["single"].tril()).abs().max().item()
        fast = n * m < 10_000
        reps = 50 if fast else 10
        library = lambda: torch.cholesky_solve(B, torch.linalg.cholesky_ex(H)[0])  # noqa: E731
        lib_x = library()
        lib_rel = ((lib_x - ref).abs().max() / ref.abs().max()).item()
        bound_ms, bound_by = bound(2.0 * S * (n ** 3 / 3 + n * n * m), 4.0 * S * (n * n + 2 * n * m))
        out[name] = dict(
            S=S, n=n, m=m, launch_shape=list(schur_cuda.launch_shape(n, m)),
            launch_plan=schur_cuda.launch_plan(S, n, m)._asdict(), factor_max_abs_diff=factor_diff,
            max_abs_err=abs_err, max_rel_err=rel_err, library_vs_plain_rel=lib_rel,
            cond=torch.linalg.cond(H.double()).max().item(),
            residual_kernel=rel_residual(H, ker, B), residual_plain=rel_residual(H, ref, B),
            residual_library=rel_residual(H, lib_x, B),
            ms=cuda_ms(lambda: schur.spd_solve(H, B), reps),
            kernel_only_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work), reps),
            kernel_single_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work, "single"), reps),
            kernel_multi_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work, "multi"), reps),
            plain_ms=cuda_ms(lambda: schur.spd_solve_plain(H, B), 3 if fast else 2),
            library_ms=cuda_ms(library, reps),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("k2_kernel", case=name, **out[name])
        rel_tol = max(K2_REL, 2.0 * lib_rel)
        res_tol = max(K2_RESIDUAL, 2.0 * out[name]["residual_library"])
        if not rel_err <= rel_tol:
            raise AssertionError(f"{name}: K2 differs from the plain version by {rel_err} > {rel_tol}")
        if not out[name]["residual_kernel"] <= res_tol:
            raise AssertionError(f"{name}: K2's residual {out[name]['residual_kernel']} > {res_tol}")
        if factor_diff != 0.0:
            raise AssertionError(f"{name}: the many-CTA factor differs from the one-CTA factor by {factor_diff}")
    return out


# --- phases 6-7 ---------------------------------------------------------------

def dense_pallas_phase(kf_dense, ro_dense, n_live: int):
    """Phase 6: the keyframe fixture and the session reoptimize with
    solve_method = "dense_pallas", against the card's "dense" runs."""
    gpu_kf, kfs, kf_secs = kf_dense
    (eng, kfs_p, secs), got = counted(lambda: run_keyframes(DEVICE, "dense_pallas"))
    if kfs_p != kfs:
        raise AssertionError(f"dense_pallas keyframes differ: {kfs_p} vs {kfs}")
    if got[K2] < len(kfs):
        raise AssertionError(f"K2 launched {got[K2]} times for {len(kfs)} keyframes")
    diff = check_same_run("dense_pallas keyframe", eng, gpu_kf)
    emit("dense_pallas", run="keyframe", keyframes=len(kfs), kf_per_s=len(kfs) / secs,
         dense_kf_per_s=len(kfs) / kf_secs, k2_launches=got[K2], k1_launches=got[K1], **diff)

    gpu_ro, ro_secs = ro_dense
    (eng, secs), got = counted(lambda: run_reoptimize(DEVICE, "dense_pallas"))
    if got[K2] < 1:
        raise AssertionError("the dense_pallas reoptimize did not launch K2")
    diff = check_same_run("dense_pallas reoptimize", eng, gpu_ro)
    emit("dense_pallas", run="reoptimize", seconds=secs, dense_seconds=ro_secs,
         pairs_per_s=n_live / secs, dense_pairs_per_s=n_live / ro_secs,
         k2_launches=got[K2], k1_launches=got[K1], **diff)


def pose_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a - b).abs().double()
    d[:, 2] = torch.remainder(d[:, 2] + np.pi, 2 * np.pi) - np.pi
    return d.abs().max().item()


def schur_phase(ro_dense, n_live):
    """Phase 7: the Schur reoptimize on SHARDS shards through K2, against
    torch.linalg's elimination and the single-card reoptimize."""
    gpu_ro, ro_secs = ro_dense
    n = gpu_ro.num_nodes()
    t0 = time.perf_counter()
    state, got = counted(lambda: session_schur(True))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if got[K2] < 1:
        raise AssertionError("the Schur reoptimize did not launch K2")
    xla = session_schur(False)
    # The separator count of the partition the solve ran on.
    N = state.poses.shape[0]
    g = state.graph
    assign = spatial_blocks(load_checkpoint(ASSETS / "session", "cpu").state.poses.numpy(),
                            (np.arange(N) < n), SHARDS)
    mask = torch.arange(N, device=DEVICE) < n
    _, sep_count, _ = schur_solve(
        make_mesh(SHARDS), state.poses, mask, g.prior_idx, g.prior_val, g.prior_sqrt_info, g.prior_mask,
        g.edge_idx, g.edge_meas, g.edge_sqrt_info, g.edge_mask, torch.as_tensor(assign, device=DEVICE),
        sep_cap=separator_cap(N), max_iterations=0,
    )
    mesh_eng = eng_mod.DpgSlamEngine(gpu_ro.config, mesh=make_mesh(SHARDS))
    mesh_eng.state = load_checkpoint(ASSETS / "session", DEVICE).state
    _, got_eng = counted(mesh_eng.increment_pass)
    out = dict(
        shards=SHARDS, separators=sep_count, sep_cap=separator_cap(N), seconds=secs,
        single_card_seconds=ro_secs, pairs_per_s=n_live / secs, single_card_pairs_per_s=n_live / ro_secs,
        k2_launches=got[K2], k1_launches=got[K1], edges=int(state.graph.num_edges),
        single_card_edges=int(gpu_ro.state.graph.num_edges),
        k2_vs_linalg=pose_diff(state.poses[:n], xla.poses[:n]),
        k2_vs_single_card=pose_diff(state.poses[:n], gpu_ro.state.poses[:n]),
        engine_mesh_vs_single_card=pose_diff(mesh_eng.state.poses[:n], gpu_ro.state.poses[:n]),
        engine_mesh_k1_launches=got_eng[K1],
    )
    emit("schur", **out)
    if sep_count > separator_cap(N):
        raise AssertionError(f"separators {sep_count} passed the cap: the solve fell back to CG")
    if not all(np.isfinite(state.poses[:n].cpu().numpy()).ravel()):
        raise AssertionError("the Schur reoptimize gave non-finite poses")
    if out["k2_vs_linalg"] > SCHUR_ELIM_TOL:
        raise AssertionError(f"K2 vs torch.linalg elimination: {out['k2_vs_linalg']} > {SCHUR_ELIM_TOL}")
    for key in ("k2_vs_single_card", "engine_mesh_vs_single_card"):
        if out[key] > SCHUR_SINGLE_TOL:
            raise AssertionError(f"{key}: {out[key]} > {SCHUR_SINGLE_TOL}")


# --- phase 8: the offline sequence mode ----------------------------------------

def run_offline(solve_method: str | None = None, pipelined: bool = False):
    """process_sequence over the keyframe fixture's continuation scans."""
    eng = load_checkpoint(ASSETS / "keyframe", DEVICE)
    if solve_method is not None:
        eng.solve_method = solve_method
    with np.load(ASSETS / "keyframe" / "continuation.npz") as cont:
        scans, odom = cont["scans"], cont["odometry"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = eng.process_sequence(odom, scans, pipelined=pipelined)
    torch.cuda.synchronize()
    return eng, mask, time.perf_counter() - t0


def offline_phase(kf_dense):
    """Phase 8: process_sequence plain and pipelined, with the default
    solve and with "dense_pallas", against phase 3's online run."""
    online, kfs, online_secs = kf_dense
    run_offline()  # warm-up: the full-capacity solve's first use
    plain = {}
    for solve in (None, "dense_pallas"):
        for pipelined in (False, True):
            (eng, mask, secs), got = counted(lambda: run_offline(solve, pipelined))
            name = f"{'pipelined' if pipelined else 'plain'}_{solve or 'default'}"
            idx = np.flatnonzero(mask).tolist()
            if idx != kfs:
                raise AssertionError(f"offline {name}: keyframes {idx} differ from the online run's {kfs}")
            if got[K1] < len(kfs) or (solve == "dense_pallas" and got[K2] < len(kfs)):
                raise AssertionError(f"offline {name}: launches {got} for {len(kfs)} keyframes")
            out = dict(run=name, keyframes=len(idx), seconds=secs, kf_per_s=len(idx) / secs,
                       online_kf_per_s=len(kfs) / online_secs, k1_launches=got[K1], k2_launches=got[K2],
                       consecutive_keyframes=int((mask[1:] & mask[:-1]).sum()),
                       **check_same_run(f"offline {name}", eng, online))
            if pipelined:
                d = np.linalg.norm(eng.trajectory()[:, :2] - plain[solve].trajectory()[:, :2], axis=1)
                out["vs_plain_max_m"] = float(d.max())
                if not d.max() < PIPELINED_TOL:
                    raise AssertionError(f"offline {name}: {d.max()} m from the plain schedule")
            else:
                plain[solve] = eng
            emit("offline", **out)


# --- phase 9: the session-batched mode -----------------------------------------

def batched_config() -> DpgConfig:
    cfg = DpgConfig.from_json((ASSETS / "keyframe" / "config.json").read_text())
    return cfg.replace(capacity=dataclasses.replace(cfg.capacity, max_edges=BATCH_MAX_EDGES))


def batched_sessions(cfg: DpgConfig, n_sessions: int, laps: int):
    """n_sessions simulated sessions of `laps` office loops at BATCH_STEP
    m steps, odometry and scan noise from seeds BATCH_SEED0, +1, ...:
    ([(odometry, scans)], [ground truth])."""
    world = dataset.make_office_world()
    wps = dataset.office_loop_waypoints()
    wps = np.vstack([wps] + [wps[1:]] * (laps - 1))
    seqs = [dataset.simulate_sequence(world, wps, cfg.scan, step=BATCH_STEP, seed=BATCH_SEED0 + i,
                                      odom_noise_transl=0.02, odom_noise_rot=0.008)
            for i in range(n_sessions)]
    return [(s.odometry, s.scans) for s in seqs], [s.ground_truth for s in seqs]


def lane_ates(cfg, states, sessions, gts, counts, align: bool = False) -> list[float]:
    """Each lane's ATE against its ground truth in the anchored frame (as
    the tests measure it), or after a best-fit SE(2) alignment."""
    out = []
    for i, (odom, _) in enumerate(sessions):
        kf_idx = np.nonzero(batch_mod.keyframe_schedule(cfg, odom))[0][: counts[i]]
        poses = batch_mod.session_state(states, i).poses[: counts[i]].cpu().numpy()
        out.append(float(ate_rmse(poses, to_anchor_frame(gts[i][kf_idx]), align=align)))
    return out


def run_batched(cfg, sessions, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, counts = batch_mod.process_sessions_batched(cfg, sessions, device=DEVICE, **kw)
    torch.cuda.synchronize()
    return states, counts, time.perf_counter() - t0


class KernelBatches:
    """Records the pair count of every K1 launch inside the block."""

    def __enter__(self):
        self.sizes, real = [], icp_cuda.run_kernel

        def record(src_planes, *args, **kwargs):
            self.sizes.append(int(src_planes.shape[1]))
            return real(src_planes, *args, **kwargs)

        self.real, icp_cuda.run_kernel = real, record
        return self

    def __exit__(self, *exc):
        icp_cuda.run_kernel = self.real


def count_syncs(run):
    """(run(), number of host syncs it made), by torch's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def captured_step_loop(cfg, sessions, capture_step: int):
    """The batched step loop alone (schedule, stacked states and uploads
    made before it), under sync debug mode; captures K1's input at step
    `capture_step` and the first lanes Cholesky system. Returns (host
    syncs inside the loop, K1 input, (H, B))."""
    steps, counts, bucket, method = batch_mod._schedule(cfg, sessions, None, BATCH_METHOD, BATCH_STRIDE)
    states = batch_mod._stack_states(cfg, len(sessions), DEVICE)
    steps = [torch.as_tensor(x, device=DEVICE) for x in steps]
    box, calls = {}, [0]
    real_align, real_solve = icp.icp_align, fg._dense_solve_lanes

    def align(*args, **kwargs):
        if calls[0] == capture_step:
            box["k1"] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                         {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()})
        calls[0] += 1
        return real_align(*args, **kwargs)

    def solve(eq, g, damping):
        if "k2" not in box:
            S, N = eq.diag.shape[:2]
            box["k2"] = (fg._dense_H(eq, g, damping).detach().clone(), eq.rhs.reshape(S, 3 * N, 1).clone())
        return real_solve(eq, g, damping)

    icp.icp_align, fg._dense_solve_lanes = align, solve
    torch.cuda.synchronize()
    try:
        _, syncs = count_syncs(lambda: batch_mod._process_sessions_batched(
            cfg, states, *steps, method, bucket, BATCH_STRIDE, BATCH_GN))
    finally:
        icp.icp_align, fg._dense_solve_lanes = real_align, real_solve
    return syncs, box["k1"], box["k2"]


def batched_k1_case(k1_input):
    """Phase 9c: K1 against the plain version on a captured batched step."""
    args, kw = k1_input
    pg = args[5]
    kw = dict(kw, min_correspondences=10, fitness_threshold=0.25, min_overlap=pg.icp_min_overlap,
              sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = icp.icp_align_plain(*args, **kw)
    err = compare("batched_step", ker, ref, pg, args[4], kw["gate_multiplier"])
    packed = icp_cuda.pack(*args[:4], kw["tgt_normals"], args[4], kw["gate_multiplier"])
    lay = layouts("batched_step", packed, pg, False, 10)
    bound_ms, bound_by = k1_bound(args, icp_cuda.run_kernel(*packed, pg, False), pg)
    case = dict(pairs=int(args[0].shape[0]), sources=int(args[0].shape[1]), targets=int(args[2].shape[1]),
                live_pairs=int(args[3].any(1).sum()),
                ms=cuda_ms(lambda: icp_cuda.icp_align_cuda(*args, **kw), 10),
                plain_ms=cuda_ms(lambda: icp.icp_align_plain(*args, **kw), 3),
                kernel_only_ms=cuda_ms(lambda: icp_cuda.run_kernel(*packed, pg, False), 10),
                bound_ms=bound_ms, bound_by=bound_by, **lay)
    emit("kernel_time", batch="batched_step", **case)
    return err, case


def batched_k2_case(H, B):
    """K2 and torch.linalg on the lanes Cholesky system of a batched solve
    (a record: the lanes solve stays on torch.linalg, as in the JAX
    package): the batched library call, with the lanes its cholesky_ex
    reports failed, and the lane-by-lane form the solve runs; the host
    syncs of each."""
    S, n, _ = H.shape
    ker = schur.spd_solve(H, B)
    torch.cuda.synchronize()
    ref = schur.spd_solve_plain(H, B)
    library = lambda: torch.cholesky_solve(B, torch.linalg.cholesky_ex(H)[0])  # noqa: E731

    def lanes_form():
        out = []
        for s in range(S):
            L, info = torch.linalg.cholesky_ex(H[s])
            out.append(torch.where(info == 0, torch.cholesky_solve(B[s], L), float("nan")))
        return torch.stack(out)

    scale = ref.abs().max()
    lanes_rel = ((lanes_form() - ref).abs().max() / scale).item()
    abs_err = (ker - ref).abs().max().item()
    bound_ms, bound_by = bound(2.0 * S * (n ** 3 / 3 + n * n), 4.0 * S * (n * n + 2 * n))
    case = dict(
        S=S, n=n, m=1, launch_plan=schur_cuda.launch_plan(S, n, 1)._asdict(), max_abs_err=abs_err,
        max_rel_err=abs_err / scale.item(), lanes_form_vs_plain_rel=lanes_rel,
        library_vs_plain_rel=((library() - ref).abs().max() / scale).item(),
        library_failed_lanes=int((torch.linalg.cholesky_ex(H)[1] != 0).sum()),
        lanes_form_failed_lanes=sum(int(torch.linalg.cholesky_ex(H[s])[1] != 0) for s in range(S)),
        residual_kernel=rel_residual(H, ker, B), residual_lanes_form=rel_residual(H, lanes_form(), B),
        ms=cuda_ms(lambda: schur.spd_solve(H, B), 20), plain_ms=cuda_ms(lambda: schur.spd_solve_plain(H, B), 2),
        library_ms=cuda_ms(library, 20), lanes_form_ms=cuda_ms(lanes_form, 20),
        library_syncs=count_syncs(library)[1], lanes_form_syncs=count_syncs(lanes_form)[1],
        bound_ms=bound_ms, bound_by=bound_by,
    )
    emit("k2_kernel", case="batched_lanes", **case)
    if not case["max_rel_err"] <= max(K2_REL, 2.0 * lanes_rel):
        raise AssertionError(f"batched lanes: K2 differs from the plain version by {case['max_rel_err']}")
    if case["lanes_form_syncs"] != 0:
        raise AssertionError("the lanes solve's Cholesky reads the host")
    return case


def batched_phase(single_stream_kf_per_s: float):
    """Phase 9: the batched mode at the configuration of record; 9b two
    one-lap lanes against process_sequence; 9c K1 on a captured step."""
    cfg = batched_config()
    t0 = time.perf_counter()
    sessions, gts = batched_sessions(cfg, BATCH_SESSIONS, BATCH_LAPS)
    sim_secs = time.perf_counter() - t0
    kw = dict(solve_method=BATCH_METHOD, solve_stride=BATCH_STRIDE, solve_gn_iterations=BATCH_GN)
    run_batched(cfg, sessions, **kw)  # warm-up
    secs, launches, sizes = [], [], set()
    for _ in range(BATCH_REPEATS):
        with KernelBatches() as kb:
            (states, counts, dt), got = counted(lambda: run_batched(cfg, sessions, **kw))
        secs.append(dt)
        launches.append(got[K1])
        sizes |= set(kb.sizes)
    steps = -(-max(counts) // BATCH_STRIDE) * BATCH_STRIDE
    ates = lane_ates(cfg, states, sessions, gts, counts)
    syncs, k1_input, (H, B) = captured_step_loop(cfg, sessions, capture_step=steps // 2)
    _, probe = count_syncs(lambda: torch.ones(1, device=DEVICE).sum().item())  # the counter sees a sync
    median = float(np.median(secs))
    out = dict(sessions=len(sessions), laps=BATCH_LAPS, scans_per_session=len(sessions[0][1]),
               keyframes=sum(counts), keyframes_per_lane=counts, steps=steps, method=BATCH_METHOD,
               stride=BATCH_STRIDE, gn_iterations=BATCH_GN, max_edges=BATCH_MAX_EDGES,
               lanes_cholesky=list(H.shape), seconds=secs, kf_per_s=sum(counts) / median,
               single_stream_kf_per_s=single_stream_kf_per_s, mean_lane_ate_m=float(np.mean(ates)),
               max_lane_ate_m=max(ates), k1_launches_per_run=launches, k1_batch_sizes=sorted(sizes),
               step_loop_host_syncs=syncs, sync_counter_probe=probe, simulate_seconds=sim_secs)
    emit("batched", **out, lane_ates_m=ates)
    if max(ates) >= LANE_ATE_MAX:
        raise AssertionError(f"lane ATE {max(ates)} m >= {LANE_ATE_MAX}")
    if any(n != steps for n in launches) or sizes != {len(sessions) * (1 + cfg.pose_graph.max_loop_closures_per_node)}:
        raise AssertionError(f"K1 launches {launches} (batch sizes {sorted(sizes)}) for {steps} steps")
    if syncs != 0 or probe < 1:
        raise AssertionError(f"{syncs} host syncs inside the batched step loop (probe {probe})")

    # 9b: two one-lap lanes at solve_stride 1 against process_sequence on
    # the card. Float atomics in index_add_ move repeated runs on the card;
    # where the largest spread among three runs of each exceeds 2e-3, the
    # bound is twice it.
    pair, _ = batched_sessions(cfg, 2, 1)
    (runs, got) = counted(lambda: [run_batched(cfg, pair)[:2] for _ in range(SPREAD_RUNS)])
    engines = []
    for _ in range(SPREAD_RUNS):
        lane_engines = []
        for odom, scans in pair:
            eng = eng_mod.DpgSlamEngine(cfg, DEVICE)
            eng.process_sequence(odom, scans)
            lane_engines.append(eng)
        engines.append(lane_engines)
    lanes = [[batch_mod.session_state(st, i) for i in range(2)] for st, _ in runs]
    spread = 0.0
    for r in range(SPREAD_RUNS):
        for q in range(r):
            for i, n in enumerate(runs[0][1]):
                spread = max(spread, pose_diff(lanes[r][i].poses[:n], lanes[q][i].poses[:n]),
                             pose_diff(engines[r][i].state.poses[:n], engines[q][i].state.poses[:n]))
    tol = LANE_POSE_TOL if spread <= LANE_POSE_TOL else 2.0 * spread
    diffs = []
    for lane, eng, n in zip(lanes[0], engines[0], runs[0][1]):
        same = (n == eng.num_nodes() and int(lane.graph.num_edges) == int(eng.state.graph.num_edges)
                and int(lane.graph.num_priors) == int(eng.state.graph.num_priors))
        if not same:
            raise AssertionError(f"batched lane and process_sequence differ in counts: {n} vs {eng.num_nodes()}")
        diffs.append(pose_diff(lane.poses[:n], eng.state.poses[:n]))
    emit("batched_vs_sequence", lanes=2, keyframes=runs[0][1], max_pose_diff=max(diffs), repeat_spread=spread,
         bound=tol, k1_launches=got[K1])
    if max(diffs) > tol:
        raise AssertionError(f"batched lanes differ from process_sequence by {max(diffs)} > {tol}")
    return out, batched_k1_case(k1_input), batched_k2_case(H, B)


# --- phase 10: DPG change detection ---------------------------------------------

def session_config() -> DpgConfig:
    return DpgConfig.from_json((ASSETS / "session" / "config.json").read_text())


def dpg_step(cfg, state):
    out = change_detection.execute_dpg(cfg, state)
    if state.poses.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def capture_icp_input(run):
    """(args, kwargs) of the ops.icp.icp_align call that `run` makes."""
    box, real = {}, icp.icp_align

    def record(*args, **kwargs):
        box["k1"] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                     {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()})
        return real(*args, **kwargs)

    icp.icp_align = record
    try:
        run()
    finally:
        icp.icp_align = real
    return box["k1"]


def dpg_diff(gpu, cpu, ginfo, cinfo, n_live: int) -> dict:
    """Entries of the card's step that differ from the CPU's, and the
    bounds they are held to."""
    g_lab, c_lab = gpu.labels[:n_live].cpu(), cpu.labels[:n_live]
    g_sec, c_sec = gpu.sector_active[:n_live].cpu(), cpu.sector_active[:n_live]
    out = dict(label_entries_differ=int((g_lab != c_lab).sum()), label_entries=g_lab.numel(),
               sector_entries_differ=int((g_sec != c_sec).sum()), sector_entries=g_sec.numel(),
               node_active_differ=int((gpu.node_active.cpu() != cpu.node_active).sum()))
    for k in ("num_added", "num_removed", "num_contributors", "coverage"):
        out[f"{k}_card"], out[f"{k}_cpu"] = float(getattr(ginfo, k)), float(getattr(cinfo, k))
    return out


def check_dpg_diff(d: dict) -> None:
    bad = []
    if d["label_entries_differ"] > DPG_ENTRY_FRAC * d["label_entries"]:
        bad.append("labels")
    if d["sector_entries_differ"] > DPG_ENTRY_FRAC * d["sector_entries"]:
        bad.append("sector_active")
    if d["node_active_differ"] or d["num_contributors_card"] != d["num_contributors_cpu"]:
        bad.append("node_active / num_contributors")
    for k in ("num_added", "num_removed"):
        if abs(d[f"{k}_card"] - d[f"{k}_cpu"]) > max(DPG_COUNT_ABS, DPG_COUNT_REL * d[f"{k}_cpu"]):
            bad.append(k)
    if abs(d["coverage_card"] - d["coverage_cpu"]) > DPG_COVERAGE_ATOL:
        bad.append("coverage")
    if bad:
        raise AssertionError(f"DPG step: card and CPU disagree on {bad}: {d}")


def dpg_step_phase():
    """Phase 10a: one execute_dpg on bench_assets/session, card against
    CPU; its time, host syncs and K1 launches. Returns K1's input."""
    cfg = session_config()
    gpu = load_checkpoint(ASSETS / "session", DEVICE).state
    cpu = load_checkpoint(ASSETS / "session", "cpu").state
    n_live = int(cpu.num_nodes)
    before = gpu.labels.clone(), gpu.sector_active.clone(), gpu.node_active.clone()
    dpg_step(cfg, gpu)  # warm: the constants, the allocator
    (g_new, g_info), got = counted(lambda: dpg_step(cfg, gpu))
    if got[K1] != 1:
        raise AssertionError(f"one DPG step launched K1 {got[K1]} times")
    _, syncs = count_syncs(lambda: change_detection.execute_dpg(cfg, gpu))
    torch.cuda.synchronize()
    wall, event = [], []
    for _ in range(DPG_REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        change_detection.execute_dpg(cfg, gpu)
        end.record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        event.append(start.elapsed_time(end))
    if any(not torch.equal(a, b) for a, b in zip(before, (gpu.labels, gpu.sector_active, gpu.node_active))):
        raise AssertionError("execute_dpg wrote into its input state")
    t0 = time.perf_counter()
    c_new, c_info = dpg_step(cfg, cpu)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    d = dpg_diff(g_new, c_new, g_info, c_info, n_live)
    out = dict(nodes=n_live, pass0_nodes=int((cpu.pass_ids[:n_live] == 0).sum()),
               wall_ms_median=float(np.median(wall)), event_ms_median=float(np.median(event)),
               wall_ms=wall, cpu_ms=cpu_ms, host_syncs=syncs, k1_launches=got[K1], **d)
    emit("dpg_step", **out)
    check_dpg_diff(d)
    if syncs != 0:
        raise AssertionError(f"{syncs} host syncs inside execute_dpg")
    return capture_icp_input(lambda: dpg_step(cfg, gpu)), out


def dpg_k1_phase(k1_input):
    """Phase 10b: K1 on the DPG step's captured batch against plain."""
    args, kw = k1_input
    pg = args[5]
    C, T = args[2].shape[:2]
    normals = icp.estimate_normals(args[2], args[3])
    gate = kw["gate_multiplier"]
    kw = dict(tgt_normals=normals, gate_multiplier=gate, min_correspondences=10, fitness_threshold=0.25,
              min_overlap=pg.icp_min_overlap, sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = icp.icp_align_plain(*args, **kw)
    err = compare("dpg_local_reg", ker, ref, pg, args[4], gate)
    packed = icp_cuda.pack(*args[:4], normals, args[4], gate)
    lay = layouts("dpg_local_reg", packed, pg, False, 20)
    if lay["rows_max_abs_diff"] != 0.0:
        raise AssertionError(f"DPG batch: rows at C = {lay['plan']} differ from C = 1 by {lay['rows_max_abs_diff']}")
    bound_ms, bound_by = k1_bound(args, icp_cuda.run_kernel(*packed, pg, False), pg)
    case = dict(pairs=int(C), sources=int(args[0].shape[1]), targets=int(T), iterations=pg.icp_maximum_iterations,
                live_pairs=int(args[1].any(1).sum()), converged=int(ker.converged.sum()),
                ms=cuda_ms(lambda: icp_cuda.icp_align_cuda(*args, **kw), 20),
                plain_ms=cuda_ms(lambda: icp.icp_align_plain(*args, **kw), 3),
                kernel_only_ms=cuda_ms(lambda: icp_cuda.run_kernel(*packed, pg, False), 20),
                bound_ms=bound_ms, bound_by=bound_by, **lay)
    emit("kernel_time", batch="dpg_local_reg", **case)
    return err, case


def dpg_scene_phase():
    """Phase 10c: tests/test_dpg.py's two-pass box scene at full width,
    online through observe_laser with DPG on; that test's bars."""
    cfg = session_config()
    base = dataset.make_office_world()
    wps = dataset.office_loop_waypoints()
    seqs = [dataset.simulate_sequence(base.add_box(2.0, 1.5, 1.0, 1.0), wps, cfg.scan, step=0.5, seed=3),
            dataset.simulate_sequence(base.add_box(-3.0, 1.5, 1.0, 1.0), wps, cfg.scan, step=0.5, seed=4)]
    eng = eng_mod.DpgSlamEngine(cfg, DEVICE)

    def drive():
        kfs, secs = [], []
        for p, seq in enumerate(seqs):
            if p:
                eng.increment_pass()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            for t in range(len(seq.scans)):
                eng.observe_odometry(seq.odometry[t])
                n += bool(eng.observe_laser(seq.scans[t]))
            torch.cuda.synchronize()
            kfs.append(n)
            secs.append(time.perf_counter() - t0)
        return kfs, secs

    (kfs, secs), got = counted(drive)
    n = eng.num_nodes()
    labels = eng.state.labels[:n].cpu().numpy()
    pass_ids = eng.state.pass_ids[:n].cpu().numpy()
    layers = eng.map_layers()
    added, removed = layers["dynamic_added"], layers["dynamic_removed"]
    def near(pts, c):
        return float((np.linalg.norm(pts - np.array(c), axis=1) < 1.5).mean()) if len(pts) else 0.0

    grid, _ = eng.occupancy_grid()
    info = {k: float(v) for k, v in eng.last_dpg_info._asdict().items()}
    rem_nodes = np.where((labels == scan.REMOVED).any(axis=1))[0]
    add_nodes = np.where((labels == scan.ADDED).any(axis=1))[0]
    out = dict(scans_per_pass=[len(s.scans) for s in seqs], keyframes=kfs,
               pass0_kf_per_s=kfs[0] / secs[0], pass1_dpg_kf_per_s=kfs[1] / secs[1],
               added=int((labels == scan.ADDED).sum()), removed=int((labels == scan.REMOVED).sum()),
               added_near_frac=near(added, (3.0, 5.5)), removed_near_frac=near(removed, (8.0, 5.5)),
               pass0_sectors_off=int((~eng.state.sector_active[: kfs[0]]).sum()),
               removed_on_pass0_only=bool(len(rem_nodes) and (pass_ids[rem_nodes] == 0).all()),
               added_on_pass1_only=bool(len(add_nodes) and (pass_ids[add_nodes] == 1).all()),
               last_info=info, map_layers={k: len(v) for k, v in layers.items()},
               occupancy_values=sorted(int(v) for v in np.unique(grid)), occupancy_shape=list(grid.shape),
               k1_launches=got[K1], jax_cpu_reference=DPG_SCENE_JAX)
    emit("dpg_scene", **out)
    bars = {"added > 0": out["added"] > 0, "removed > 0": out["removed"] > 0,
            "added near new box > 0.9": out["added_near_frac"] > 0.9,
            "removed near old box > 0.6": out["removed_near_frac"] > 0.6,
            "removed on pass-0 nodes only": out["removed_on_pass0_only"],
            "added on pass-1 nodes only": out["added_on_pass1_only"],
            "a pass-0 sector deactivated": out["pass0_sectors_off"] > 0,
            "K1 ran": got[K1] >= sum(kfs) + kfs[1]}
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise AssertionError(f"DPG scene misses {failed}: {out}")
    return out


def run_dpg_offline(cfg, state, odom, scans, run_dpg: bool):
    """process_sequence from `state` with its odometry gate re-anchored
    (a fresh odometry stream in the same pass): (engine, mask, seconds)."""
    eng = eng_mod.DpgSlamEngine(cfg, DEVICE)
    eng.state = state._replace(odom_initialized=torch.zeros_like(state.odom_initialized))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = eng.process_sequence(odom, scans, run_dpg=run_dpg)
    torch.cuda.synchronize()
    return eng, mask, time.perf_counter() - t0


def dpg_offline_phase():
    """Phase 10d: process_sequence over DPG_OFFLINE_SCANS scans of the
    office loop (seed 9) from bench_assets/session, pass 1, without and
    with DPG (bench.py's bench_dpg part b)."""
    cfg = session_config()
    seq = dataset.simulate_sequence(dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan,
                                    step=0.5, seed=9, odom_noise_transl=0.02, odom_noise_rot=0.008)
    odom, scans = seq.odometry[:DPG_OFFLINE_SCANS], seq.scans[:DPG_OFFLINE_SCANS]
    state = load_checkpoint(ASSETS / "session", DEVICE).state
    run = functools.partial(run_dpg_offline, cfg, state, odom, scans)
    res = {}
    for run_dpg in (False, True):
        run(run_dpg)  # warm
        res[run_dpg], got = counted(lambda: run(run_dpg))
        res[run_dpg] += (got[K1],)
    (e0, m0, s0, k0), (e1, m1, s1, k1) = res[False], res[True]
    kf = int(m1.sum())
    out = dict(scans=len(scans), keyframes=kf, kf_per_s_no_dpg=int(m0.sum()) / s0, kf_per_s_dpg=kf / s1,
               dpg_ms_per_keyframe=1e3 * (s1 - s0) / max(kf, 1), same_keyframes=bool((m0 == m1).all()),
               k1_launches_no_dpg=k0, k1_launches_dpg=k1,
               last_info={k: float(v) for k, v in e1.last_dpg_info._asdict().items()} if e1.last_dpg_info else None)
    emit("dpg_offline", **out)
    if not out["same_keyframes"] or kf == 0 or e1.last_dpg_info is None or e0.last_dpg_info is not None:
        raise AssertionError(f"offline DPG run: {out}")
    if k1 != k0 + kf:
        raise AssertionError(f"offline DPG: K1 launched {k1} times, {k0} without DPG, {kf} keyframes")
    return out


def dpg_phase():
    """Phase 10: DPG change detection (10a-d), each part's seconds printed;
    returns K1's DPG case."""
    marks = [time.perf_counter()]
    k1_input, _ = dpg_step_phase()
    marks.append(time.perf_counter())
    err, case = dpg_k1_phase(k1_input)
    marks.append(time.perf_counter())
    dpg_scene_phase()
    marks.append(time.perf_counter())
    dpg_offline_phase()
    marks.append(time.perf_counter())
    emit("dpg_seconds", **{part: b - a for part, a, b in zip(("10a", "10b", "10c", "10d"), marks, marks[1:])},
         total=marks[-1] - marks[0])
    return err, case


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
    _nvcc.build_all([icp_cuda._SRC, schur_cuda._SRC])  # one nvcc each, together
    icp_cuda._load()
    schur_cuda._load()
    emit("build", seconds=time.perf_counter() - t0, kernels=[K1, K2])

    cfg = DpgConfig.from_json((ASSETS / "keyframe" / "config.json").read_text())
    worst, times, n_live = kernel_phase(cfg)
    k2 = k2_kernel_phase()

    # The paths: each runs with the counts at 0 (counted) and adds to LAUNCHED.
    kf_dense = keyframe_phase()
    counted(lambda: ate_phase(cfg))
    ro_dense = reoptimize_phase(n_live)
    dense_pallas_phase(kf_dense, ro_dense, n_live)
    schur_phase(ro_dense, n_live)
    offline_phase(kf_dense)
    _, (batched_err, batched_k1), batched_k2 = batched_phase(len(kf_dense[1]) / kf_dense[2])
    times["batched_step"] = batched_k1
    dpg_err, times["dpg_local_reg"] = dpg_phase()
    for name, launches in LAUNCHED.items():
        if launches == 0:
            raise AssertionError(f"the paths never launched {name}")

    ro = times["reoptimize"]
    k2_main = k2["reoptimize_dense"]
    print(json.dumps({"kernels": [
        {
            "name": K1,
            "route": "cuda",
            "source": "dpg_slam_tpu_torch/csrc/icp_kernel.cu",
            "replaces": "dpg_slam_tpu/ops/icp_pallas.py:170",
            "launches": LAUNCHED[K1],
            "max_abs_err": max(worst, batched_err, dpg_err),
            "ms": ro["ms"],
            "plain_ms": ro["plain_ms"],
            "bound_ms": ro["bound_ms"],
            "bound_by": ro["bound_by"],
            "library_ms": None,
            "cases": times,
        },
        {
            "name": K2,
            "route": "cuda",
            "source": "dpg_slam_tpu_torch/csrc/spd_solve_kernel.cu",
            "replaces": "dpg_slam_tpu/ops/schur_pallas.py:247",
            "launches": LAUNCHED[K2],
            "max_abs_err": max(max(v["max_abs_err"] for v in k2.values()), batched_k2["max_abs_err"]),
            "ms": k2_main["ms"],
            "plain_ms": k2_main["plain_ms"],
            "bound_ms": k2_main["bound_ms"],
            "bound_by": k2_main["bound_by"],
            "library_ms": k2_main["library_ms"],
            "cases": {name: {k: v[k] for k in ("S", "n", "m", "launch_plan", "ms", "kernel_only_ms", "kernel_single_ms",
                                                 "kernel_multi_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                 "factor_max_abs_diff")}
                      for name, v in k2.items()} | {"batched_lanes": batched_k2},
        },
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
