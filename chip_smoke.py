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
  2b k2_kernel   K2 vs plain, vs torch.linalg's Cholesky and vs a float64
                 solve on the inputs its three paths give it (captured from
                 those paths): residuals, factor residuals, distances from
                 the float64 solution; its launch plan; both factorization
                 layouts (one CTA per system, many CTAs per system) timed,
                 and the factors they leave compared
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
 11 multipass    process_sessions_multipass at the JAX package's multipass
                 configuration of record (8 lanes x 2 passes of 2 office
                 laps, a box moved between passes, a solve every 4
                 keyframes): 11a aggregate kf/s (median of 2 after a warm
                 run), the keyframe total against the host schedule, every
                 pass-lane's ATE (< 0.25 m), ADDED and REMOVED on every
                 lane, edges at each pass's end, K1's launches (2 a pass-1
                 step: 72 and 40 pairs), host syncs inside the pass-1 step
                 loop (must be 0), the last three read on a run of the
                 same entry with its inner parts wrapped; 11b one run at
                 stride 32 (recorded); 11c the lane-axis DPG step on a
                 captured pass-1 state and on 16 lanes of
                 bench_assets/session, each lane against the one-lane
                 step, timed beside the one-lane steps, with its device ops
                 and peak memory; 11d K1 on the captured 72-pair frontend
                 batch, 40-pair DPG batch and 8-lane reoptimize sweep
                 against plain; 11e batched_increment_pass against each
                 lane's engine reoptimize: ICP rows and rebuilt graphs to
                 the bit, poses within the bound
 12 server       BatchedSlamServer at the batched configuration of record
                 (phase 9's 16 sessions, default bucket 256 and "lanes_cg",
                 a solve every executed step), T = min(300, shortest
                 session) ticks after a warm server of 40: 12a the policies
                 (min_batch_fraction, max_wait_calls) = (1.0, 8), (0.5, 8),
                 (0.25, 2) with kf/s (host clock from the first observe to
                 a sync after flush), steps, keyframes, wait p50 / p95, K1
                 launches and host syncs in the tick loop (must be 0), the
                 JAX package's TPU row beside each; 12b immediate mode
                 against process_sessions_batched at stride 1 per lane; 12c
                 lane ATE at (0.5, 8) (< 0.3 m); 12d K1 on a captured
                 server step with padding lanes against plain

Repeats: the reoptimize (phase 5), 2b's dense_pallas reoptimize capture,
9b's batched lanes and process_sequence runs and 11e's
batched_increment_pass and engine reoptimizes each run more than once and
must give the same bits (the pose-graph sums are ordered segment sums);
each prints a "repeat" line.

Each path phase (3-12) runs with the kernels' launch counts set to 0 just
before it and read just after. Each phase prints one JSON line; any failed
check raises, so the exit code is non-zero. The last lines are the
kernels' record, the card's nvidia-smi line and {"ok": true, "device":
{...}}. Without a CUDA device it raises before doing anything.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
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
from dpg_slam_tpu_torch.utils.checkpoint import load_checkpoint, state_from_numpy, state_to_numpy
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
# K2's accuracy, against the float32 solvers beside it on the same input
# (the plain version and torch.linalg's Cholesky, or the lane-at-a-time
# Cholesky in phase 9c):
# - backward: the relative residual |H X - B| / |B| within 1e-5 or twice
#   the library's, and the factor's max |L L^T - H| / max |H| (in float64)
#   within 1e-6 or twice the library factor's;
# - forward, phase 2b: max |X_k - X_64| / max |X_64|, X_64 a float64 solve
#   of the same system, within 1e-4 or twice the farther of the plain
#   version's and the library's distances from it. The dense_pallas
#   reoptimize's system (condition ~5e9) leaves every float32 solution
#   0.2-7 from the float64 one but within ~25 % of each other, so K2 is
#   held to the truth and not to a second float32 answer;
# - forward, phase 9c: max |X_k - X_p| / max |X_p| within 1e-4 or twice
#   the lane-at-a-time Cholesky's distance from the plain version.
K2_REL = 1e-4
K2_RESIDUAL = 1e-5
K2_FACTOR = 1e-6
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
# Online server (phase 12) at the batched configuration of record: bench.py's
# bench_server sweep (T = min(300, shortest session) ticks after a warm
# server of 40; the default bucket, max_nodes = 256, and solve choice,
# "lanes_cg"). Lane ATE at (0.5, 8) below tests/test_batch.py's server bar;
# immediate mode against the offline stride-1 run within LANE_POSE_TOL.
SERVER_TICKS, SERVER_WARM_TICKS = 300, 40
SERVER_POLICIES = ((1.0, 8), (0.5, 8), (0.25, 2))
SERVER_QUALITY_POLICY = (0.5, 8)
SERVER_ATE_MAX = 0.3
# The JAX package's server on a TPU at these policies (BENCH_r05.json,
# server_sweep): history, not comparable with the card's numbers.
SERVER_TPU = {(1.0, 8): dict(kf_per_s=319.2, device_steps=69, keyframes=1096, p50_wait_ticks=1.0, p95_wait_ticks=2.0),
              (0.5, 8): dict(kf_per_s=341.9, device_steps=82, keyframes=977, p50_wait_ticks=1.0, p95_wait_ticks=4.0),
              (0.25, 2): dict(kf_per_s=208.3, device_steps=162, keyframes=1136, p50_wait_ticks=1.0, p95_wait_ticks=2.0)}
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
# Multipass batched mode (phase 11) at the JAX package's configuration of
# record (bench.py:1272-1290, build_multipass_sessions; nothing cut): the
# keyframe config with max_edges 2,048, a 512² DPG window and M = 16; 8
# lanes x 2 passes of 2 office laps at 0.25 m steps, a box at (2, 1.5) in
# pass 0 and one at (-3, 1.5) instead in pass 1, seeds 31 + 2i and 32 + 2i,
# odometry noise 0.02 / 0.008; a solve every 4 keyframes, 5 LM steps, the
# default solve choice. kf/s is the median of MULTI_REPEATS timed runs
# after a warm one. Every pass-lane's anchored ATE below 0.25 m
# (tests/test_batch.py's bar) and ADDED and REMOVED points on every lane.
# The JAX package's TPU run of this configuration counted 1,296 keyframes
# (BENCH_r05.json; the count, not a time, is comparable).
MULTI_LANES, MULTI_LAPS, MULTI_STEP, MULTI_SEED0 = 8, 2, 0.25, 31
MULTI_STRIDE, MULTI_STRIDE_RECORD, MULTI_GN = 4, 32, 5
MULTI_MAX_EDGES, MULTI_EXTENT, MULTI_M = 2048, 512, 16
MULTI_REPEATS = 2
MULTI_JAX_KEYFRAMES = 1296
MULTI_DPG_REPEATS = 20
MULTI_DPG_LARGE_LANES = 16
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the
# tensor cores (an FMA counted as two flops) and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 instruction rate of an H100 SXM: 128 lanes x 132 SMs x 1.98 GHz
# (boost clock). K1's distance arithmetic has no FMA (its d2 helper
# forbids contraction), so each of its operations takes one instruction.
PEAK_FP32_INSTR = 128 * 132 * 1.98e9

K1, K2 = "icp_point_to_line", "spd_solve"
# Launches on the paths (phases 3-11), summed over the phases.
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


def check_repeats(name: str, runs) -> float:
    """Repeats of one computation on the card, each a list of tensors:
    every repeat must equal the first to the bit. Prints a "repeat" line;
    returns the largest absolute difference."""
    same, diff = True, 0.0
    for other in runs[1:]:
        for a, b in zip(runs[0], other, strict=True):
            same = same and same_bits(a, b)
            if a.is_floating_point() and a.numel():
                diff = max(diff, (a.double() - b.double()).abs().max().item())
    emit("repeat", run=name, repeats=len(runs), max_abs_diff=diff, same_bits=same)
    if not same:
        raise AssertionError(f"{name}: repeated runs on the card differ (max {diff})")
    return diff


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


def k1_case(name: str, k1_input, reps: int):
    """K1 on a captured icp_align input against the plain version (phase
    2's tolerances), with its launch plan and its time at every cluster
    size; the rows at the planned C must equal C = 1's."""
    args, kw = k1_input
    pg = args[5]
    B, T = args[2].shape[:2]
    normals = kw.get("tgt_normals")
    normals = icp.estimate_normals(args[2], args[3]) if normals is None else normals
    gate = kw["gate_multiplier"]
    kw = dict(tgt_normals=normals, gate_multiplier=gate, min_correspondences=10, fitness_threshold=0.25,
              min_overlap=pg.icp_min_overlap, sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = icp.icp_align_plain(*args, **kw)
    err = compare(name, ker, ref, pg, args[4], gate)
    packed = icp_cuda.pack(*args[:4], normals, args[4], gate)
    lay = layouts(name, packed, pg, False, reps)
    if lay["rows_max_abs_diff"] != 0.0:
        raise AssertionError(f"{name}: rows at C = {lay['plan']} differ from C = 1 by {lay['rows_max_abs_diff']}")
    bound_ms, bound_by = k1_bound(args, icp_cuda.run_kernel(*packed, pg, False), pg)
    case = dict(pairs=int(B), sources=int(args[0].shape[1]), targets=int(T), iterations=pg.icp_maximum_iterations,
                live_pairs=int((args[1].any(1) & args[3].any(1)).sum()), converged=int(ker.converged.sum()),
                ms=cuda_ms(lambda: icp_cuda.icp_align_cuda(*args, **kw), reps),
                plain_ms=cuda_ms(lambda: icp.icp_align_plain(*args, **kw), 3),
                kernel_only_ms=cuda_ms(lambda: icp_cuda.run_kernel(*packed, pg, False), reps),
                bound_ms=bound_ms, bound_by=bound_by, **lay)
    emit("kernel_time", batch=name, **case)
    return err, case


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
    (again, _), _ = counted(lambda: run_reoptimize(DEVICE))
    check_repeats("reoptimize", [[e.state.poses, *e.state.graph] for e in (gpu, again)])
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
    reopt = [capture_spd_input(lambda: run_reoptimize(DEVICE, "dense_pallas")) for _ in range(2)]
    check_repeats("reoptimize_dense capture", [list(x) for x in reopt])
    return {
        "keyframe_dense": capture_spd_input(lambda: run_keyframes(DEVICE, "dense_pallas")),
        "reoptimize_dense": reopt[0],
        "schur_4_shards": capture_spd_input(lambda: session_schur(True)),
    }


def rel_residual(H, X, B):
    return ((H @ X - B).abs().amax() / B.abs().amax()).item()


def f64_distances(H, B, **solutions) -> dict:
    """Each float32 solution's max |X - X_64| / max |X_64|, X_64 a float64
    solve of the same system."""
    x64 = torch.linalg.solve(H.double(), B.double())
    scale = x64.abs().max()
    return {k: ((x.double() - x64).abs().max() / scale).item() for k, x in solutions.items()}


def factor_residual(H, L) -> float:
    """max |L L^T - H| / max |H| in float64, L in the lower triangle."""
    L = L.double().tril()
    return ((L @ L.transpose(-1, -2) - H.double()).abs().amax() / H.abs().amax()).item()


def k2_accuracy(name, H, B, ker, ker_factor, lib_factor, forward: bool, **others) -> dict:
    """K2's residual and its factor's beside the first other solution's
    and the library factor's, and every solution's distance from a float64
    solve; raises where K2 is outside K2_RESIDUAL / K2_FACTOR or twice the
    library's, or, with `forward`, outside K2_REL or twice the farther
    other's distance from the float64 solve (NaN lanes of a failed
    factorization drop out of that bound)."""
    first = next(iter(others))
    acc = {f"{k}_vs_f64_rel": v for k, v in f64_distances(H, B, kernel=ker, **others).items()}
    acc.update(residual_kernel=rel_residual(H, ker, B), **{f"residual_{first}": rel_residual(H, others[first], B)},
               factor_residual_kernel=factor_residual(H, ker_factor), factor_residual_library=factor_residual(H, lib_factor))
    res_tol = max(K2_RESIDUAL, 2.0 * acc[f"residual_{first}"])
    fac_tol = max(K2_FACTOR, 2.0 * acc["factor_residual_library"])
    f64_tol = max([K2_REL] + [2.0 * acc[f"{k}_vs_f64_rel"] for k in others if np.isfinite(acc[f"{k}_vs_f64_rel"])])
    if not acc["residual_kernel"] <= res_tol:
        raise AssertionError(f"{name}: K2's residual {acc['residual_kernel']} > {res_tol}")
    if not acc["factor_residual_kernel"] <= fac_tol:
        raise AssertionError(f"{name}: K2's factor residual {acc['factor_residual_kernel']} > {fac_tol}")
    if forward and not acc["kernel_vs_f64_rel"] <= f64_tol:
        raise AssertionError(f"{name}: K2 is {acc['kernel_vs_f64_rel']} from the float64 solution > {f64_tol}")
    return acc


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
        acc = k2_accuracy(name, H, B, ker, factors["single"], torch.linalg.cholesky_ex(H)[0], True,
                          library=lib_x, plain=ref)
        bound_ms, bound_by = bound(2.0 * S * (n ** 3 / 3 + n * n * m), 4.0 * S * (n * n + 2 * n * m))
        out[name] = dict(
            S=S, n=n, m=m, launch_shape=list(schur_cuda.launch_shape(n, m)),
            launch_plan=schur_cuda.launch_plan(S, n, m)._asdict(), factor_max_abs_diff=factor_diff,
            max_abs_err=abs_err, max_rel_err=rel_err, library_vs_plain_rel=lib_rel,
            cond=torch.linalg.cond(H.double()).max().item(), **acc, residual_plain=rel_residual(H, ref, B),
            ms=cuda_ms(lambda: schur.spd_solve(H, B), reps),
            kernel_only_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work), reps),
            kernel_single_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work, "single"), reps),
            kernel_multi_ms=cuda_ms(lambda: schur_cuda.run_kernel(H, B, X, work, "multi"), reps),
            plain_ms=cuda_ms(lambda: schur.spd_solve_plain(H, B), 3 if fast else 2),
            library_ms=cuda_ms(library, reps),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("k2_kernel", case=name, **out[name])
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

    def solve(eq, g, damping, plan=None):
        if "k2" not in box:
            S, N = eq.diag.shape[:2]
            box["k2"] = (fg._dense_H(eq, g, damping, plan).detach().clone(), eq.rhs.reshape(S, 3 * N, 1).clone())
        return real_solve(eq, g, damping, plan)

    icp.icp_align, fg._dense_solve_lanes = align, solve
    torch.cuda.synchronize()
    try:
        _, syncs = count_syncs(lambda: batch_mod._process_sessions_batched(
            cfg, states, *steps, method, bucket, BATCH_STRIDE, BATCH_GN))
    finally:
        icp.icp_align, fg._dense_solve_lanes = real_align, real_solve
    return syncs, box["k1"], box["k2"]


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

    work = torch.empty_like(H)
    schur_cuda.run_kernel(H, B, torch.empty_like(B), work)
    lane_factors = torch.stack([torch.linalg.cholesky_ex(H[s])[0] for s in range(S)])
    scale = ref.abs().max()
    lanes_x = lanes_form()
    lanes_rel = ((lanes_x - ref).abs().max() / scale).item()
    abs_err = (ker - ref).abs().max().item()
    bound_ms, bound_by = bound(2.0 * S * (n ** 3 / 3 + n * n), 4.0 * S * (n * n + 2 * n))
    case = dict(
        S=S, n=n, m=1, launch_plan=schur_cuda.launch_plan(S, n, 1)._asdict(), max_abs_err=abs_err,
        max_rel_err=abs_err / scale.item(), lanes_form_vs_plain_rel=lanes_rel,
        library_vs_plain_rel=((library() - ref).abs().max() / scale).item(),
        library_failed_lanes=int((torch.linalg.cholesky_ex(H)[1] != 0).sum()),
        lanes_form_failed_lanes=sum(int(torch.linalg.cholesky_ex(H[s])[1] != 0) for s in range(S)),
        **k2_accuracy("batched lanes", H, B, ker, work, lane_factors, False, lanes_form=lanes_x, plain=ref),
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
    # the card. Repeats of each must give the same bits; the pose bound is
    # 2e-3, or twice the largest spread among three runs of each where that
    # is larger (the bound of card runs with float atomics in the sums).
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
    check_repeats("9b batched lanes", [[st.poses, *st.graph] for st, _ in runs])
    check_repeats("9b process_sequence", [[e.state.poses for e in lane_engines] for lane_engines in engines])
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
    return out, k1_case("batched_step", k1_input, 10), batched_k2_case(H, B), (sessions, gts)


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
    err, case = k1_case("dpg_local_reg", k1_input, 20)
    marks.append(time.perf_counter())
    dpg_scene_phase()
    marks.append(time.perf_counter())
    dpg_offline_phase()
    marks.append(time.perf_counter())
    emit("dpg_seconds", **{part: b - a for part, a, b in zip(("10a", "10b", "10c", "10d"), marks, marks[1:])},
         total=marks[-1] - marks[0])
    return err, case


# --- phase 11: the multipass batched mode ----------------------------------------

def multipass_config() -> DpgConfig:
    cfg = DpgConfig.from_json((ASSETS / "keyframe" / "config.json").read_text())
    return cfg.replace(capacity=dataclasses.replace(cfg.capacity, max_edges=MULTI_MAX_EDGES),
                       dpg=dataclasses.replace(cfg.dpg, grid_extent_cells=MULTI_EXTENT, max_submap_nodes=MULTI_M))


def multipass_lanes(cfg: DpgConfig):
    """MULTI_LANES two-pass lanes of MULTI_LAPS office laps (the box scene
    of bench.py's build_multipass_sessions): ([[(odometry, scans)] a pass]
    a lane, [(ground truth a pass)] a lane)."""
    base = dataset.make_office_world()
    worlds = base.add_box(2.0, 1.5, 1.0, 1.0), base.add_box(-3.0, 1.5, 1.0, 1.0)
    wps = dataset.office_loop_waypoints()
    wps = np.vstack([wps] + [wps[1:]] * (MULTI_LAPS - 1))
    lanes, gts = [], []
    for i in range(MULTI_LANES):
        seqs = [dataset.simulate_sequence(w, wps, cfg.scan, step=MULTI_STEP, seed=MULTI_SEED0 + 2 * i + p,
                                          odom_noise_transl=0.02, odom_noise_rot=0.008)
                for p, w in enumerate(worlds)]
        lanes.append([(q.odometry, q.scans) for q in seqs])
        gts.append([q.ground_truth for q in seqs])
    return lanes, gts


def run_multipass(cfg, lanes, stride: int = MULTI_STRIDE):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, counts = batch_mod.process_sessions_multipass(cfg, lanes, solve_stride=stride,
                                                          solve_gn_iterations=MULTI_GN, device=DEVICE)
    torch.cuda.synchronize()
    return states, counts, time.perf_counter() - t0


def multipass_quality(cfg, states, lanes, gts, counts) -> dict:
    """Each pass-lane's ATE against its ground truth, anchored (as the
    tests and the JAX bench measure it) and best-fit aligned; each lane's
    ADDED and REMOVED points, and the lanes x kinds with any."""
    anchored, aligned, changes = [], [], []
    for i, passes in enumerate(lanes):
        lane = batch_mod.session_state(states, i)
        poses, labels = lane.poses.cpu().numpy(), lane.labels.cpu().numpy()
        k0 = 0
        for p, (odom, _) in enumerate(passes):
            k = counts[i][p]
            gt = to_anchor_frame(gts[i][p][np.nonzero(batch_mod.keyframe_schedule(cfg, odom))[0][:k]])
            anchored.append(float(ate_rmse(poses[k0:k0 + k], gt)))
            aligned.append(float(ate_rmse(poses[k0:k0 + k], gt, align=True)))
            k0 += k
        changes.append([int((labels[:k0] == scan.ADDED).sum()), int((labels[:k0] == scan.REMOVED).sum())])
    return dict(pass_lane_ates_m=anchored, max_pass_lane_ate_m=max(anchored), mean_pass_lane_ate_m=float(np.mean(anchored)),
                pass_lane_ates_aligned_m=aligned, max_pass_lane_ate_aligned_m=max(aligned), changes_per_lane=changes,
                detections=sum((a > 0) + (r > 0) for a, r in changes))


def clone_states(states):
    return batch_mod._tree_map(torch.clone, states)


def clone_input(args, kwargs):
    return ([a.clone() if torch.is_tensor(a) else a for a in args],
            {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()})


def multipass_captured(cfg, lanes, capture_step: int) -> dict:
    """One process_sessions_multipass run at the configuration of record
    with its parts wrapped: each pass's step loop with its solve method and
    bucket and the edge counts at its end, the pass-1 loop under sync debug
    mode with its K1 batch sizes; the stacked state before the pass
    boundary, the edge counts after it and the reoptimize's K1 input; at
    pass-1 step `capture_step`, the frontend's K1 input, and the stacked
    state before the lanes' DPG step with that step's K1 input."""
    out, box = dict(edges_end_of_pass=[], methods=[]), {}
    real_loop, real_pass = batch_mod._process_sessions_batched, batch_mod.batched_increment_pass
    real_dpg, real_align = batch_mod._lanes_dpg, icp.icp_align
    bind = inspect.signature(real_loop).bind
    dpg_calls, track_calls = [0], [0]

    def loop(*args, **kwargs):
        a = bind(*args, **kwargs).arguments
        out["methods"].append([a["solve_method"], a["solve_bucket"]])
        if a.get("run_dpg"):
            torch.cuda.synchronize()
            box["pass1"] = True
            with KernelBatches() as kb:
                states, out["pass1_loop_host_syncs"] = count_syncs(lambda: real_loop(*args, **kwargs))
            box["pass1"] = False
            out["pass1_k1_sizes"], out["pass1_steps"] = kb.sizes, int(a["kf_valid"].shape[0])
        else:
            states = real_loop(*args, **kwargs)
        out["edges_end_of_pass"].append(states.graph.num_edges.tolist())
        return states

    def increment_pass(c, states, *args, **kwargs):
        out["pass0_states"] = clone_states(states)
        box["in_reopt"] = True
        try:
            states = real_pass(c, states, *args, **kwargs)
        finally:
            box["in_reopt"] = False
        out["edges_after_reoptimize"] = states.graph.num_edges.tolist()
        return states

    def lanes_dpg(c, st, valid):
        box["in_dpg"] = dpg_calls[0] == capture_step
        if box["in_dpg"]:
            box["dpg_state"] = clone_states(st)
        dpg_calls[0] += 1
        box["dpg"] = True
        try:
            return real_dpg(c, st, valid)
        finally:
            box["dpg"] = box["in_dpg"] = False

    def align(*args, **kwargs):
        if box.get("in_reopt"):
            box["reopt_k1"] = clone_input(args, kwargs)
        elif box.get("in_dpg"):
            box["dpg_k1"] = clone_input(args, kwargs)
        elif box.get("pass1") and not box.get("dpg"):
            if track_calls[0] == capture_step:
                box["track_k1"] = clone_input(args, kwargs)
            track_calls[0] += 1
        return real_align(*args, **kwargs)

    batch_mod._process_sessions_batched, batch_mod.batched_increment_pass = loop, increment_pass
    batch_mod._lanes_dpg, icp.icp_align = lanes_dpg, align
    try:
        _, out["counts"] = batch_mod.process_sessions_multipass(cfg, lanes, solve_stride=MULTI_STRIDE,
                                                                solve_gn_iterations=MULTI_GN, device=DEVICE)
    finally:
        batch_mod._process_sessions_batched, batch_mod.batched_increment_pass = real_loop, real_pass
        batch_mod._lanes_dpg, icp.icp_align = real_dpg, real_align
    out.update(dpg_state=box["dpg_state"], dpg_k1=box["dpg_k1"], reopt_k1=box["reopt_k1"], track_k1=box["track_k1"])
    return out


def multipass_phase(single_stream_kf_per_s: float, batched_kf_per_s: float):
    """Phase 11a-b: the multipass batched mode at its configuration of
    record, timed; the captured run; stride 32. Returns (the captured run,
    the configuration)."""
    cfg = multipass_config()
    lanes, gts = multipass_lanes(cfg)
    host_kf = sum(min(int(batch_mod.keyframe_schedule(cfg, odom).sum()), cfg.capacity.max_nodes,
                      cfg.capacity.max_edges // (2 + cfg.pose_graph.max_loop_closures_per_node))
                  for lane in lanes for odom, _ in lane)
    K1_track = MULTI_LANES * (1 + cfg.pose_graph.max_loop_closures_per_node)
    K1_dpg = MULTI_LANES * cfg.dpg.current_pose_chain_len
    run_multipass(cfg, lanes)  # warm-up
    secs, launches, sizes = [], [], set()
    for _ in range(MULTI_REPEATS):
        with KernelBatches() as kb:
            (states, counts, dt), got = counted(lambda: run_multipass(cfg, lanes))
        secs.append(dt)
        launches.append(got[K1])
        sizes |= set(kb.sizes)
    total = sum(sum(c) for c in counts)
    quality = multipass_quality(cfg, states, lanes, gts, counts)
    steps = [-(-max(c[p] for c in counts) // MULTI_STRIDE) * MULTI_STRIDE for p in range(2)]
    cap = multipass_captured(cfg, lanes, capture_step=steps[1] // 2)
    p1_sizes = cap["pass1_k1_sizes"]
    median = float(np.median(secs))
    out = dict(lanes=MULTI_LANES, passes=2, laps=MULTI_LAPS, scans_per_pass=len(lanes[0][0][1]),
               keyframes=total, keyframes_host_schedule=host_kf, keyframes_jax_tpu_record=MULTI_JAX_KEYFRAMES,
               keyframes_per_lane=counts, steps_per_pass=steps, stride=MULTI_STRIDE, gn_iterations=MULTI_GN,
               methods_by_pass=cap["methods"], seconds=secs, kf_per_s=total / median,
               batched_kf_per_s_phase9=batched_kf_per_s, single_stream_kf_per_s_phase3=single_stream_kf_per_s,
               edges_end_of_pass=cap["edges_end_of_pass"], edges_after_reoptimize=cap["edges_after_reoptimize"],
               max_edges=cfg.capacity.max_edges, k1_launches_per_run=launches, k1_batch_sizes=sorted(sizes),
               pass1_k1_launches_per_step=len(p1_sizes) / cap["pass1_steps"], pass1_k1_batch_sizes=sorted(set(p1_sizes)),
               pass1_loop_host_syncs=cap["pass1_loop_host_syncs"], **quality)
    emit("multipass", **out)
    if total != host_kf or cap["counts"] != counts:
        raise AssertionError(f"multipass keyframes {total} ({cap['counts']}) against the host schedule's {host_kf}")
    if quality["max_pass_lane_ate_m"] >= LANE_ATE_MAX:
        raise AssertionError(f"pass-lane ATE {quality['max_pass_lane_ate_m']} m >= {LANE_ATE_MAX}")
    if quality["detections"] != 2 * MULTI_LANES:
        raise AssertionError(f"changes found in {quality['detections']} of {2 * MULTI_LANES} lanes x kinds")
    if (any(n != steps[0] + 2 * steps[1] + 1 for n in launches) or len(p1_sizes) != 2 * cap["pass1_steps"]
            or set(p1_sizes) != {K1_track, K1_dpg}):
        raise AssertionError(f"K1 launches {launches}, pass-1 sizes {sorted(set(p1_sizes))} for steps {steps}")
    if cap["pass1_loop_host_syncs"] != 0:
        raise AssertionError(f"{cap['pass1_loop_host_syncs']} host syncs inside the pass-1 step loop")

    # 11b: the batched mode's cadence of record, recorded and not gated.
    (states, counts, dt), got = counted(lambda: run_multipass(cfg, lanes, MULTI_STRIDE_RECORD))
    q = multipass_quality(cfg, states, lanes, gts, counts)
    emit("multipass_stride32", stride=MULTI_STRIDE_RECORD, keyframes=sum(sum(c) for c in counts), seconds=dt,
         kf_per_s=sum(sum(c) for c in counts) / dt, k1_launches=got[K1], **q)
    return cap, cfg


def lane_dpg_diffs(cfg, states, new, info) -> list[dict]:
    """Each lane of a lane-axis step against the one-lane step on that
    lane's state (dpg_diff, the card on both sides)."""
    out = []
    for i in range(states.poses.shape[0]):
        one, one_info = change_detection.execute_dpg(cfg, batch_mod.session_state(states, i))
        one = one._replace(**{k: getattr(one, k).cpu() for k in ("labels", "sector_active", "node_active")})
        d = dpg_diff(batch_mod.session_state(new, i), one, change_detection.DpgStepInfo(*(x[i] for x in info)),
                     one_info, int(states.num_nodes[i]))
        check_dpg_diff(d)
        out.append(d)
    return out


def dpg_timing(run, reps: int) -> dict:
    """Median host wall and CUDA-event ms of run() over reps calls after a
    warm one, each ending in a sync."""
    run()
    wall, event = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        event.append(start.elapsed_time(end))
    return dict(wall_ms=float(np.median(wall)), event_ms=float(np.median(event)))


def device_ops(run) -> int:
    """CUDA kernels and copies of one run() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def peak_mib(run) -> float:
    """MiB allocated at the peak of run() above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def lane_step_record(name: str, cfg, states) -> dict:
    """Phase 11c on one stacked state: the lane-axis step against the
    one-lane steps per lane, its host syncs (0), time, device ops and peak
    memory beside the loop of one-lane steps."""
    S = states.poses.shape[0]
    new, info = change_detection.execute_dpg_lanes(cfg, states)
    diffs = lane_dpg_diffs(cfg, states, new, info)
    lane_step = lambda: change_detection.execute_dpg_lanes(cfg, states)  # noqa: E731
    one_lane_steps = lambda: [change_detection.execute_dpg(cfg, batch_mod.session_state(states, i))  # noqa: E731
                              for i in range(S)]
    _, syncs = count_syncs(lane_step)
    out = dict(lanes=S, extent=cfg.dpg.grid_extent_cells, submap_nodes=cfg.dpg.max_submap_nodes,
               nodes=states.num_nodes.tolist(), label_entries_differ=[d["label_entries_differ"] for d in diffs],
               sector_entries_differ=[d["sector_entries_differ"] for d in diffs],
               node_active_differ=[d["node_active_differ"] for d in diffs],
               num_added=info.num_added.tolist(), num_removed=info.num_removed.tolist(),
               num_contributors=info.num_contributors.tolist(), host_syncs=syncs,
               lane_step=dpg_timing(lane_step, MULTI_DPG_REPEATS),
               one_lane_steps=dpg_timing(one_lane_steps, MULTI_DPG_REPEATS),
               lane_step_device_ops=device_ops(lane_step), one_lane_steps_device_ops=device_ops(one_lane_steps),
               lane_step_peak_mib=peak_mib(lane_step), one_lane_step_peak_mib=peak_mib(
                   lambda: change_detection.execute_dpg(cfg, batch_mod.session_state(states, 0))))
    emit("multipass_dpg", case=name, **out)
    if syncs != 0:
        raise AssertionError(f"{name}: {syncs} host syncs inside the lane-axis DPG step")
    return out


def multipass_dpg_phase(cap, cfg):
    """Phase 11c: the lane-axis DPG step on the captured pass-1 stacked
    state (8 lanes, 512² window), and on 16 copies of bench_assets/session
    (1,024² window, M = 32)."""
    lane_step_record("multipass_pass1_8_lanes", cfg, cap["dpg_state"])
    session = load_checkpoint(ASSETS / "session", "cpu")
    flat = {k: np.stack([v] * MULTI_DPG_LARGE_LANES) for k, v in state_to_numpy(session.state).items()}
    lane_step_record("session_16_lanes", session.config,
                     state_from_numpy(flat, session.config, DEVICE, lanes=MULTI_DPG_LARGE_LANES))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b equal to the bit (NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8))
    return torch.equal(a, b)


def icp_results(run):
    """(run(), the ICPResult of every icp_align call it made)."""
    rows, real = [], icp.icp_align

    def record(*args, **kwargs):
        rows.append(real(*args, **kwargs))
        return rows[-1]

    icp.icp_align = record
    try:
        return run(), rows
    finally:
        icp.icp_align = real


def multipass_reoptimize_phase(cap, cfg):
    """Phase 11e: batched_increment_pass on the card on the captured pass-0
    states against each lane's engine reoptimize; both timed. Per lane, the
    one-launch sweep's ICP rows must equal the engine's own sweep's rows to
    the bit (K1's rows do not depend on the batch), and so must the rebuilt
    graphs. As in phase 9b each side runs SPREAD_RUNS times, the repeats
    must give the same bits, and the pose bound is POSE_TOL, or twice the
    largest spread between repeats where that is larger."""
    pass0 = cap["pass0_states"]
    S = pass0.poses.shape[0]
    nodes = pass0.num_nodes.tolist()
    batch_mod.batched_increment_pass(cfg, clone_states(pass0))  # warm
    batched, engines, batched_ms, one_lane_ms = [], [], [], []
    for r in range(SPREAD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, b_rows = icp_results(lambda: batch_mod.batched_increment_pass(cfg, clone_states(pass0)))
        torch.cuda.synchronize()
        batched_ms.append(1e3 * (time.perf_counter() - t0))
        batched.append(b)
        lane_engines = [eng_mod.DpgSlamEngine(cfg, DEVICE) for _ in range(S)]
        t0 = time.perf_counter()
        for i, eng in enumerate(lane_engines):
            eng.state = batch_mod.session_state(pass0, i)
        _, e_rows = icp_results(lambda: [eng.increment_pass() for eng in lane_engines])
        torch.cuda.synchronize()
        one_lane_ms.append(1e3 * (time.perf_counter() - t0))
        engines.append([eng.state for eng in lane_engines])
        if r == 0:
            first_rows = b_rows, e_rows
    check_repeats("11e batched_increment_pass", [[b.poses, *b.graph] for b in batched])
    check_repeats("11e engine reoptimizes", [[st.poses for st in lane_states] for lane_states in engines])
    (sweep,), e_rows = first_rows
    B = sweep.transform.shape[0] // S
    rows_equal = [all(same_bits(x[i * B:i * B + y.shape[0]], y) for x, y in zip(sweep, e_rows[i]))
                  for i in range(S)]
    lanes = [[batch_mod.session_state(b, i) for i in range(S)] for b in batched]
    graphs_equal = [all(same_bits(x, y) for x, y in zip(a.graph, e.graph)) for a, e in zip(lanes[0], engines[0])]
    spread = max(pose_diff(runs[r][i].poses[:n], runs[q][i].poses[:n])
                 for runs in (lanes, engines) for r in range(SPREAD_RUNS) for q in range(r)
                 for i, n in enumerate(nodes))
    tol = POSE_TOL if spread <= POSE_TOL else 2.0 * spread
    diffs = [pose_diff(lanes[0][i].poses[:n], engines[0][i].poses[:n]) for i, n in enumerate(nodes)]
    out = dict(lanes=S, nodes=nodes, edges=batched[0].graph.num_edges.tolist(), sweep_pairs=int(sweep.transform.shape[0]),
               lane_sweep_pairs=[int(r.transform.shape[0]) for r in e_rows], icp_rows_equal=rows_equal,
               graphs_equal=graphs_equal, max_pose_diff=max(diffs), pose_diffs=diffs, repeat_spread=spread, bound=tol,
               batched_ms=batched_ms, one_lane_reoptimizes_ms=one_lane_ms)
    emit("multipass_reoptimize", **out)
    if len(e_rows) != S or not all(rows_equal) or not all(graphs_equal) or max(diffs) > tol:
        raise AssertionError(f"batched_increment_pass differs from the engine's reoptimize: {out}")


def multipass_all(single_stream_kf_per_s: float, batched_kf_per_s: float):
    """Phase 11 (11a-e), each part's seconds printed; returns K1's three
    multipass cases."""
    marks = [time.perf_counter()]
    cap, cfg = multipass_phase(single_stream_kf_per_s, batched_kf_per_s)
    marks.append(time.perf_counter())
    multipass_dpg_phase(cap, cfg)
    marks.append(time.perf_counter())
    cases = {name: k1_case(name, cap[key], 10) for name, key in (("multipass_track", "track_k1"),
                                                                ("multipass_dpg", "dpg_k1"),
                                                                ("multipass_reoptimize", "reopt_k1"))}
    marks.append(time.perf_counter())
    multipass_reoptimize_phase(cap, cfg)
    marks.append(time.perf_counter())
    emit("multipass_seconds", **{part: b - a for part, a, b in zip(("11ab", "11c", "11d", "11e"), marks, marks[1:])},
         total=marks[-1] - marks[0])
    return cases


# --- phase 12: the online server -----------------------------------------------

def server_streams(sessions):
    """The first T = min(SERVER_TICKS, shortest session) ticks of every
    session, time-major: odometry (T, S, 3), scans (T, S, B)."""
    T = min(SERVER_TICKS, min(len(odom) for odom, _ in sessions))
    return np.stack([odom[:T] for odom, _ in sessions], axis=1), np.stack([scans[:T] for _, scans in sessions], axis=1)


def make_server(cfg, S: int, frac: float, wait: int):
    return batch_mod.BatchedSlamServer(cfg, S, min_batch_fraction=frac, max_wait_calls=wait, device=DEVICE)


def tick_loop(srv, odo, scn) -> list[list[int]]:
    """observe() every tick, then flush(); returns each lane's keyframe
    ticks."""
    kf_ticks = [[] for _ in range(srv.S)]
    for t in range(len(odo)):
        for i in np.nonzero(srv.observe(odo[t], scn[t]))[0]:
            kf_ticks[i].append(t)
    srv.flush()
    return kf_ticks


def server_quality(srv, odo, gts) -> list[float]:
    """Each lane's ATE: its keyframes matched to the tick with the nearest
    odometry (tests/test_batch.py::test_server_bounded_delay_quality)."""
    ates = []
    for i in range(srv.S):
        n = srv.num_nodes(i)
        odom_xy = srv.states.odom_poses[i, :n, :2].cpu().numpy()
        ticks = np.argmin(np.linalg.norm(odo[:, i, None, :2] - odom_xy[None], axis=-1), axis=0)
        ates.append(float(ate_rmse(srv.trajectory(i), to_anchor_frame(gts[i][ticks]))))
    return ates


def server_sweep(cfg, odo, scn, gts) -> list[dict]:
    """12a and 12c: one timed server per policy after a warm one."""
    T, S = odo.shape[:2]
    pairs = S * (1 + cfg.pose_graph.max_loop_closures_per_node)
    tick_loop(make_server(cfg, S, *SERVER_QUALITY_POLICY), odo[:SERVER_WARM_TICKS], scn[:SERVER_WARM_TICKS])
    rows = []
    for frac, wait in SERVER_POLICIES:
        srv = make_server(cfg, S, frac, wait)
        torch.cuda.synchronize()
        with KernelBatches() as kb:
            t0 = time.perf_counter()
            (_, syncs), got = counted(lambda: count_syncs(lambda: tick_loop(srv, odo, scn)))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        waits = np.concatenate(srv.wait_hist)
        row = dict(min_batch_fraction=frac, max_wait_calls=wait, sessions=S, ticks=T, bucket=srv.bucket,
                   method=srv.method, seconds=secs, kf_per_s=srv.keyframes_executed / secs,
                   steps=srv.steps_executed, keyframes=srv.keyframes_executed,
                   p50_wait_ticks=float(np.percentile(waits, 50)), p95_wait_ticks=float(np.percentile(waits, 95)),
                   k1_launches=got[K1], k1_batch_sizes=sorted(set(kb.sizes)), tick_loop_host_syncs=syncs,
                   tpu_history=SERVER_TPU[(frac, wait)])
        if (frac, wait) == SERVER_QUALITY_POLICY:
            ates = server_quality(srv, odo, gts)
            row |= dict(mean_lane_ate_m=float(np.mean(ates)), max_lane_ate_m=max(ates), lane_ates_m=ates)
            if max(ates) >= SERVER_ATE_MAX:
                raise AssertionError(f"server lane ATE {max(ates)} m >= {SERVER_ATE_MAX}")
        emit("server", **row)
        if syncs != 0:
            raise AssertionError(f"{syncs} host syncs in the server's tick loop at {(frac, wait)}")
        if got[K1] != srv.steps_executed or set(kb.sizes) != {pairs}:
            raise AssertionError(f"K1 launches {got[K1]} (batch sizes {sorted(set(kb.sizes))}) for "
                                 f"{srv.steps_executed} steps")
        rows.append(row)
    return rows


def server_vs_offline(cfg, odo, scn) -> dict:
    """12b: the server in immediate mode against process_sessions_batched
    at stride 1 with the same bucket and method, per lane."""
    S = odo.shape[1]
    srv = make_server(cfg, S, 1e-9, 8)
    (kf_ticks, (off, counts)), got = counted(lambda: (tick_loop(srv, odo, scn), batch_mod.process_sessions_batched(
        cfg, [(odo[:, i], scn[:, i]) for i in range(S)], solve_bucket=srv.bucket, solve_method=srv.method,
        device=DEVICE)))
    diffs, bit_equal = [], []
    for i in range(S):
        lane, n = batch_mod.session_state(off, i), counts[i]
        sched = np.nonzero(batch_mod.keyframe_schedule(cfg, odo[:, i]))[0].tolist()
        ne = int(lane.graph.num_edges)
        same = (kf_ticks[i] == sched and srv.num_nodes(i) == n
                and int(srv.states.graph.num_priors[i]) == int(lane.graph.num_priors)
                and int(srv.states.graph.num_edges[i]) == ne
                and same_bits(srv.states.odom_poses[i, :n], lane.odom_poses[:n])
                and torch.equal(srv.states.graph.edge_idx[i, :ne], lane.graph.edge_idx[:ne]))
        if not same:
            raise AssertionError(f"server lane {i} differs from the offline run in its schedule, counts, "
                                 "odometry or edges")
        diffs.append(pose_diff(srv.states.poses[i, :n], lane.poses[:n]))
        server_lane = batch_mod.session_state(srv.states, i)
        bit_equal.append(all(same_bits(a, b) for a, b in zip([server_lane.poses, *server_lane.graph],
                                                             [lane.poses, *lane.graph])))
    out = dict(sessions=S, ticks=len(odo), keyframes=counts, steps=srv.steps_executed, max_pose_diff=max(diffs),
               bound=LANE_POSE_TOL, lanes_bit_equal=sum(bit_equal), k1_launches=got[K1])
    emit("server_vs_offline", **out)
    if max(diffs) > LANE_POSE_TOL:
        raise AssertionError(f"server lanes differ from the offline run by {max(diffs)} > {LANE_POSE_TOL}")
    return out


def capture_server_step(cfg, odo, scn):
    """K1's input at the first step of a server at SERVER_QUALITY_POLICY
    with padding lanes (lanes whose every source point is masked)."""
    S = odo.shape[1]
    box, real = {}, icp.icp_align

    def align(*args, **kwargs):
        if not bool(args[1].reshape(S, -1).any(1).all()):
            box["k1"] = clone_input(args, kwargs)
            raise _Captured
        return real(*args, **kwargs)

    icp.icp_align = align
    try:
        tick_loop(make_server(cfg, S, *SERVER_QUALITY_POLICY), odo, scn)
    except _Captured:
        pass
    finally:
        icp.icp_align = real
    if "k1" not in box:
        raise AssertionError("no server step with padding lanes")
    return box["k1"]


def server_phase(sessions, gts):
    """Phase 12 (12a-d) on phase 9's sessions; returns K1's server case."""
    cfg = batched_config()
    odo, scn = server_streams(sessions)
    marks = [time.perf_counter()]
    server_sweep(cfg, odo, scn, gts)
    marks.append(time.perf_counter())
    server_vs_offline(cfg, odo, scn)
    marks.append(time.perf_counter())
    case = k1_case("server_step", capture_server_step(cfg, odo, scn), 10)
    marks.append(time.perf_counter())
    emit("server_seconds", **{part: b - a for part, a, b in zip(("12ac", "12b", "12d"), marks, marks[1:])},
         total=marks[-1] - marks[0])
    return case


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
    batched, (batched_err, batched_k1), batched_k2, streams = batched_phase(len(kf_dense[1]) / kf_dense[2])
    times["batched_step"] = batched_k1
    dpg_err, times["dpg_local_reg"] = dpg_phase()
    multi = multipass_all(len(kf_dense[1]) / kf_dense[2], batched["kf_per_s"])
    for name, (_, case) in multi.items():
        times[name] = case
    server_err, times["server_step"] = server_phase(*streams)
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
            "max_abs_err": max(worst, batched_err, dpg_err, server_err, *(err for err, _ in multi.values())),
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
