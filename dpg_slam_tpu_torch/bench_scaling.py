"""Scaling harness: the edge-sharded CG solve and the Schur-elimination
solve timed over mesh sizes at the reference scale (a 4,096-node graph),
with the hardware-free communication study and an analytic crossover
model of the two paths on the card's constants — the port of
dpg_slam_tpu/bench_scaling.py.

A mesh of S shards lives on one device unless the run is started under
torchrun, where its shards split over the ranks (parallel/mesh.py). On one
card the rows measure S shards as one device's batched work, so their
efficiency says how the per-shard batching costs, not how S cards scale.

Usage:
  python -m dpg_slam_tpu_torch.bench_scaling [--nodes 4096] [--mesh-sizes 1 2 4 8]
  python -m dpg_slam_tpu_torch.bench_scaling --device cpu --nodes 256
  torchrun --nproc-per-node=W -m dpg_slam_tpu_torch.bench_scaling [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.parallel.distributed import distributed_solve
from dpg_slam_tpu_torch.parallel.mesh import make_mesh
from dpg_slam_tpu_torch.parallel.multihost import global_mesh, initialize_multihost
from dpg_slam_tpu_torch.parallel.partition import spatial_blocks
from dpg_slam_tpu_torch.parallel.schur import schur_solve

__all__ = [
    "CHIP", "build_big_graph", "build_multipass_positions_edges", "separator_count_host", "comm_structure_study",
    "crossover_model", "crossover_study", "parse_args", "run", "main",
]

BUDGETS = (5, 10, 20, 40)


def build_big_graph(N, cap, closures_per_node=2, seed=0, device="cuda"):
    """A random-walk trajectory of N nodes with closures_per_node / 4
    random loop closures a node, in a graph of cap node slots: returns
    (graph, init (cap, 3) noisy poses, node mask (cap,), gt (N, 3) float64
    numpy). The ground-truth chain is composed step by step in float32 on
    the CPU; the graph is then moved to `device`."""
    rng = np.random.default_rng(seed)
    steps = np.stack([np.ones(N - 1), np.zeros(N - 1), rng.uniform(-0.3, 0.3, N - 1)], axis=1)
    gt = np.zeros((N, 3), np.float64)
    steps_t = torch.tensor(steps, dtype=torch.float32)
    pose = torch.zeros(3, dtype=torch.float32)
    for i in range(1, N):
        pose = geom.compose(pose, steps_t[i - 1])
        gt[i] = pose.numpy()

    E_cap = cap * (1 + closures_per_node) + 16
    g = fg.empty_graph(max_priors=4, max_edges=E_cap, device="cpu")
    g = fg.add_prior(g, 0, torch.tensor(gt[0], dtype=torch.float32),
                     fg.sqrt_info_from_sigmas(torch.tensor([0.05, 0.05, 0.02])))
    model_np = np.diag([1 / 0.1, 1 / 0.1, 1 / 0.05]).astype(np.float32)

    ei = np.arange(N - 1)
    ej = ei + 1
    ci = rng.integers(0, N - 12, size=(N * closures_per_node) // 4)
    cj = ci + rng.integers(10, min(N // 4, 500), size=len(ci))
    cj = np.minimum(cj, N - 1)
    all_i = np.concatenate([ei, ci])
    all_j = np.concatenate([ej, cj])

    def rel(a, b):
        c, s = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        dx, dy = gt[b, 0] - gt[a, 0], gt[b, 1] - gt[a, 1]
        return np.stack([c * dx + s * dy, -s * dx + c * dy, np.angle(np.exp(1j * (gt[b, 2] - gt[a, 2])))], axis=1)

    meas = rel(all_i, all_j).astype(np.float32)
    E = len(all_i)
    edge_idx = np.zeros((E_cap, 2), np.int32)
    edge_idx[:E, 0] = all_i
    edge_idx[:E, 1] = all_j
    edge_meas = np.zeros((E_cap, 3), np.float32)
    edge_meas[:E] = meas
    edge_si = np.zeros((E_cap, 3, 3), np.float32)
    edge_si[:E] = model_np[None]
    g = g._replace(
        edge_idx=torch.from_numpy(edge_idx),
        edge_meas=torch.from_numpy(edge_meas),
        edge_sqrt_info=torch.from_numpy(edge_si),
        num_edges=torch.tensor(E, dtype=torch.int32),
    )
    init = torch.zeros((cap, 3))
    init[:N] = torch.tensor(gt + rng.normal(0, 0.05, (N, 3)), dtype=torch.float32)
    mask = torch.arange(cap) < N
    g = fg.FactorGraph(*(x.to(device) for x in g))
    return g, init.to(device), mask.to(device), gt


def build_multipass_positions_edges(n_per_pass, passes, closures_per_node=1):
    """Pure-numpy multi-pass workload skeleton: a loop trajectory traversed
    `passes` times (the reference's real workloads — 4-10 sessions over the
    same space, dpg_data_runner_main.cc:95-128) with an odometry chain and
    cross-pass closures between co-located nodes of adjacent passes.

    Returns (positions (N, 2), edge_idx (E, 2)); feeds the hardware-free
    comm-structure study.
    """
    N = n_per_pass * passes
    t = np.linspace(0, 2 * np.pi, n_per_pass, endpoint=False)
    xy = np.stack([10.0 * np.cos(t), 10.0 * np.sin(t)], axis=1)
    pos = np.tile(xy, (passes, 1))
    ei = [np.arange(N - 1)]
    ej = [np.arange(1, N)]
    base = np.arange(n_per_pass)
    for p in range(1, passes):
        for k in range(closures_per_node):
            # Same-position node of the previous pass, jittered +-k index.
            tgt = (base + k) % n_per_pass + (p - 1) * n_per_pass
            ei.append(tgt)
            ej.append(base + p * n_per_pass)
    edge_idx = np.stack([np.concatenate(ei), np.concatenate(ej)], axis=1)
    return pos, edge_idx


def separator_count_host(edge_idx, assign):
    """Separators under a node->shard assignment: endpoints of cross-shard
    edges (the replicated classification in parallel/schur.py)."""
    cross = assign[edge_idx[:, 0]] != assign[edge_idx[:, 1]]
    sep = np.zeros(assign.shape[0], bool)
    sep[edge_idx[cross, 0]] = True
    sep[edge_idx[cross, 1]] = True
    return int(sep.sum())


def comm_structure_study(cg_iterations=48):
    """Hardware-free comm-volume table: separator counts and summed bytes a
    GN iteration for the SPATIAL partition against the contiguous one,
    swept over (nodes-per-pass, passes, shards).

    Under the spatial (Morton) partition of parallel/partition.py the
    separator set — and with it the Schur path's summed volume — grows
    ~ passes x shards (trajectory boundary crossings), not ~ N; the
    contiguous split degenerates to nearly all closure endpoints. CG sums
    ~ N x cg_iterations values a GN iteration whatever the partition.
    """
    rows = []
    for passes in (2, 4):
        for n_per_pass in (128, 512, 2048):
            N = n_per_pass * passes
            pos, edge_idx = build_multipass_positions_edges(n_per_pass, passes)
            for shards in (2, 4, 8):
                if N % shards:
                    continue
                assign_sp = spatial_blocks(pos, np.ones(N, bool), shards)
                assign_ct = (np.arange(N) // (N // shards)).astype(np.int32)
                sep_sp = separator_count_host(edge_idx, assign_sp)
                sep_ct = separator_count_host(edge_idx, assign_ct)
                # The cap a caller would choose for this separator set.
                cap = max(16, -(-sep_sp // 8) * 8)
                schur_bytes = 4 * ((3 * cap) ** 2 + 3 * cap + 3 * N)
                cg_bytes = 4 * (9 * N + 3 * N + cg_iterations * (3 * N + 2))
                rows.append({
                    "nodes": N, "passes": passes, "shards": shards,
                    "edges": int(edge_idx.shape[0]),
                    "sep_spatial": sep_sp, "sep_contiguous": sep_ct,
                    "schur_psum_bytes_per_iter": schur_bytes,
                    "cg_psum_bytes_per_gn_iter": cg_bytes,
                })
    return rows


# The card's constants for the analytic crossover, under the key names of
# the JAX package's table (so its dictionary can be passed in): the
# "ici_*" keys hold the cards' NVLink figures.
CHIP = {
    # FP32 outside the tensor cores, an FMA as two flops: NVIDIA H100 SXM5
    # 80GB data sheet, 67 TFLOP/s (TF32 is off in the port).
    "flops": 6.7e13,
    # HBM3: NVIDIA H100 SXM5 80GB data sheet, 3.35 TB/s.
    "hbm_bw": 3.35e12,
    # One device op's issue time on the card, back to back (a sum over the
    # shard dimension is one op on a one-card mesh): 6.8 us measured by
    # chip_smoke.py phase 15 on an NVIDIA H100 80GB HBM3 at 700 W, which
    # prints its reading beside this value. A collective across cards adds
    # NCCL's own latency, which one card cannot measure.
    "ici_latency_s": 6.8e-6,
    # NVLink 4: NVIDIA H100 SXM5 80GB data sheet, 900 GB/s a card in both
    # directions together, so 450 GB/s each way.
    "ici_bw": 4.5e11,
}


def crossover_model(N, shards, sep, cg_iters, gn_iters=5, chip=CHIP):
    """Analytic per-solve time of the two distributed paths on `chip`'s
    constants. Returns (t_cg_s, t_schur_s, terms dict).

    Edge-sharded CG (parallel/distributed.py): every CG matvec sums an
    (N, 3) partial vector over the shards — gn_iters x cg_iters collectives
    of 12N bytes each over NVLink, each paying the collective latency —
    plus O(E/shards) local matvec work (gathers bound by HBM bandwidth).

    Schur (parallel/schur.py): a GN iteration sums the reduced separator
    system ((3 sep)^2 + 3 sep floats) once, after a local dense interior
    elimination of O((N/shards)^3 / 3 + (N/shards)^2 sep) FP32 flops,
    and solves the reduced system ((3 sep)^3 / 3 flops) on every card: one
    collective an iteration against CG's cg_iters.
    """
    E = N * 2  # chain + ~1 closure/node, the workload class here
    coll = chip["ici_latency_s"]
    # CG: local matvec ~ gather 2*(E/shards)*9*4 bytes + vector ops.
    t_cg_local = gn_iters * cg_iters * (2 * (E / shards) * 9 * 4) / chip["hbm_bw"]
    t_cg_comm = gn_iters * cg_iters * (coll + 12.0 * N / chip["ici_bw"])
    t_cg = t_cg_local + t_cg_comm
    # Schur: interior elimination (blocked Cholesky class) + separator sum
    # + reduced solve ((3 sep)^3 / 3, replicated).
    ni = 3 * (N / shards)
    ns = 3 * sep
    t_sc_local = gn_iters * ((ni ** 3 / 3 + ni ** 2 * ns) / chip["flops"])
    t_sc_comm = gn_iters * (coll + 4.0 * (ns ** 2 + ns) / chip["ici_bw"])
    t_sc_red = gn_iters * (ns ** 3 / 3 / chip["flops"])
    t_schur = t_sc_local + t_sc_comm + t_sc_red
    return t_cg, t_schur, {
        "cg_local_s": t_cg_local, "cg_comm_s": t_cg_comm,
        "schur_local_s": t_sc_local, "schur_comm_s": t_sc_comm,
        "schur_reduced_s": t_sc_red,
    }


def crossover_study(cg_iters=48, gn_iters=5, chip=CHIP):
    """Where each distributed path wins in wall clock on `chip`'s constants
    (default: the card's, CHIP), over (N, shards) of the multipass
    workload, with its separator counts under the spatial partition.

    CG has a latency floor of gn_iters x cg_iters collective latencies
    that does not depend on N; Schur's cost is FP32 compute on
    (N/shards)^3. So Schur wins below a compute / latency crossover in
    N/shards and loses above it, where CG's HBM-bound matvecs amortize.
    The rows say on which side each size falls, and what share of the
    Schur time is the local elimination."""
    rows = []
    for passes in (2, 4):
        for n_per_pass in (128, 512, 2048, 8192):
            N = n_per_pass * passes
            pos, edge_idx = build_multipass_positions_edges(n_per_pass, passes)
            for shards in (4, 8, 16):
                if N % shards:
                    continue
                assign = spatial_blocks(pos, np.ones(N, bool), shards)
                sep = separator_count_host(edge_idx, assign)
                t_cg, t_sc, terms = crossover_model(N, shards, sep, cg_iters, gn_iters, chip)
                rows.append({
                    "nodes": N, "passes": passes, "shards": shards,
                    "separators": sep,
                    "t_cg_ms": round(t_cg * 1e3, 3),
                    "t_schur_ms": round(t_sc * 1e3, 3),
                    "winner": "schur" if t_sc < t_cg else "cg",
                    "cg_latency_floor_ms": round(gn_iters * cg_iters * chip["ici_latency_s"] * 1e3, 3),
                    "schur_local_share": round(terms["schur_local_s"] / max(t_sc, 1e-12), 2),
                })
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--nodes", type=int, default=4096)
    parser.add_argument("--mesh-sizes", type=int, nargs="*", default=[1, 2, 4, 8])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--tol", type=float, default=0.03,
                        help="iso-accuracy target (max trajectory err, m) "
                             "both solver paths must reach before timing")
    parser.add_argument("--family", default="all", choices=["all", "cg", "schur"],
                        help="which solver family to time")
    parser.add_argument("--structure-only", action="store_true",
                        help="emit only the hardware-free comm-structure "
                             "table (no timing runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu; under torchrun each rank "
                             "takes its LOCAL_RANK card (NCCL), or the CPU over gloo with cpu")
    return parser.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dpg_slam_tpu_torch.bench_scaling: no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def _device_record(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(index)
    return lines[index] if index < len(lines) else lines[0]


def run(args: argparse.Namespace):
    """The timing rows on parsed arguments. Under torchrun's variables the
    run joins their process group and each mesh size that splits over the
    ranks runs on global_mesh; else on make_mesh in this process. Returns
    (results, solves, rank): results as main prints them; solves maps
    ("cg" | "schur", mesh size) to the poses of that row's timed repeats."""
    device = _device(args.device)
    joined = initialize_multihost(device=device.type)
    try:
        return _run(args, device, joined)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, device, joined):
    world, rank = (dist.get_world_size(), dist.get_rank()) if joined else (1, 0)
    if joined:
        device = global_mesh(world).device

    def mesh_for(n):
        """The n-shard mesh, or None where n shards do not split over the ranks."""
        if not joined:
            return make_mesh(n, device)
        return global_mesh(n) if n >= world and n % world == 0 else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def log(family, row):
        if rank == 0:
            print(f"# {family} {row}", file=sys.stderr, flush=True)

    phys = os.cpu_count() or 1

    def oversubscribed(n):
        """Shards beyond the CPU's cores; on cards, shards beyond the ranks
        (S shards on one card are one device's work)."""
        return n > (world if device.type == "cuda" else phys)

    N = args.nodes
    tol = args.tol

    # Iso-accuracy: each path first searches the GN budget that reaches
    # max_err <= tol on this workload, then times at that budget, so the
    # rows compare solves of equal quality.
    def max_err(out, gt):
        return float(np.linalg.norm(out[:N, :2].cpu().numpy() - gt[:, :2], axis=1).max())

    def find_budget(run_fn, gt):
        for budget in BUDGETS:
            err = max_err(run_fn(budget), gt)
            if err <= tol:
                break
        return budget, err

    def timed(run_fn):
        """Mean seconds of args.repeats calls (the caller makes an untimed
        one first) and their outputs."""
        sync()
        t0 = time.perf_counter()
        outs = [run_fn() for _ in range(args.repeats)]
        sync()
        return (time.perf_counter() - t0) / args.repeats, outs

    solves = {}
    g, init, mask, gt = build_big_graph(N, N, device=device)
    factors = (g.prior_idx, g.prior_val, g.prior_sqrt_info, g.prior_mask,
               g.edge_idx, g.edge_meas, g.edge_sqrt_info, g.edge_mask)
    results = {"nodes": N, "edges": int(g.num_edges), "backend": device.type, "device": _device_record(device)}

    rows = []
    base_time = None
    for n_dev in (args.mesh_sizes if args.family in ("all", "cg") else []):
        mesh = mesh_for(n_dev)
        if mesh is None or g.edge_idx.shape[0] % n_dev != 0:
            continue

        def run_cg(budget, mesh=mesh):
            return distributed_solve(mesh, init, mask, *factors, max_iterations=budget)

        budget, err = find_budget(run_cg, gt)
        run_cg(budget)
        dt, outs = timed(lambda: run_cg(budget))
        solves["cg", n_dev] = outs
        if base_time is None:
            base_time = dt
        rows.append({
            "mesh": n_dev,
            "gn_budget": budget,
            "solve_ms": round(dt * 1e3, 1),
            "speedup": round(base_time / dt, 2),
            "efficiency": round(base_time / dt / n_dev, 2),
            "max_err_m": round(err, 4),
            **({"oversubscribed_structural_only": True} if oversubscribed(n_dev) else {}),
        })
        log("cg", rows[-1])
    results["distributed_solve"] = rows

    # Schur path: one reduced-system sum a GN iteration instead of one a
    # CG matvec.
    g2, init2, mask2, gt2 = build_big_graph(N, N, closures_per_node=0, seed=1, device=device)
    factors2 = (g2.prior_idx, g2.prior_val, g2.prior_sqrt_info, g2.prior_mask,
                g2.edge_idx, g2.edge_meas, g2.edge_sqrt_info, g2.edge_mask)
    schur_rows = []
    schur_base = None
    for n_dev in (args.mesh_sizes if args.family in ("all", "schur") else []):
        mesh = mesh_for(n_dev)
        if mesh is None or N % n_dev != 0:
            continue
        sep_cap = max(8 * n_dev, 16)

        def run_schur(budget, rel_tol=0.0, mesh=mesh, sep_cap=sep_cap):
            return schur_solve(mesh, init2, mask2, *factors2, sep_cap=sep_cap, max_iterations=budget, rel_tol=rel_tol)

        budget, err = find_budget(lambda b: run_schur(b)[0], gt2)
        _, sep_count, _ = run_schur(budget)
        # Converged-iteration count under the rel_tol stop (against the
        # fixed budget the timing rows use).
        _, _, conv_iters = run_schur(args.iters, rel_tol=1e-5)
        dt, outs = timed(lambda: run_schur(budget)[0])
        solves["schur", n_dev] = outs
        if schur_base is None:
            schur_base = dt
        schur_rows.append({
            "mesh": n_dev,
            "separators": int(sep_count),
            "gn_budget": budget,
            "converged_lm_iters": int(conv_iters),
            "solve_ms": round(dt * 1e3, 1),
            "speedup": round(schur_base / dt, 2),
            "efficiency": round(schur_base / dt / n_dev, 2),
            "max_err_m": round(err, 4),
            **({"oversubscribed_structural_only": True} if oversubscribed(n_dev) else {}),
        })
        log("schur", schur_rows[-1])
    results["schur_solve_chain"] = schur_rows
    results["comm_structure"] = comm_structure_study()
    results["crossover"] = crossover_study()
    results["physical_cores"] = phys
    if device.type == "cuda":
        results["note"] = (
            f"{world} card(s); a row's shards beyond the cards run on one card as one device's batched work "
            "(oversubscribed rows flagged), so its speedup and efficiency measure that batching, not cards: "
            "wall clock across cards needs several cards; the 'crossover' table models the H100 constants "
            "in CHIP (published peaks, and a collective latency measured as one op's issue time on one card)"
        )
    else:
        results["note"] = (
            "CPU meshes share one host's cores; efficiency numbers are structural indicators only "
            "(oversubscribed rows flagged); the 'crossover' table models the H100 constants in CHIP, "
            "not this host"
        )
    return results, solves, rank


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.structure_only:
        print(json.dumps({"comm_structure": comm_structure_study()}, indent=2))
        return 0
    results, _, rank = run(args)
    if rank == 0:
        print(json.dumps(results, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
