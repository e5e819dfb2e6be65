"""Distributed ICP and pose-graph solving over a mesh of shards — the port
of dpg_slam_tpu/parallel/distributed.py.

- ``sharded_icp_align``: the batched ICP over a pair axis divisible by the
  shard count (one kernel launch covers every shard's pairs).
- ``distributed_solve``: LM with edge-sharded PCG; the edges are reshaped
  to (S, E / S), each psum of the JAX package is a sum over the shard
  dimension, and the replicated priors are folded into every shard scaled
  by 1 / S. Per-node sums are ordered segment sums (graph/segment.py), so
  runs on the card repeat to the bit.
- ``distributed_reoptimize``: the pass-boundary reoptimize (compacted ICP
  sweep, graph rebuild) with the Schur solve (parallel/schur.py) or the
  edge-sharded CG.

A mesh is S shards on one device (parallel/mesh.py).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.config import PoseGraphParams
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.graph.segment import segment_plan, segment_sum
from dpg_slam_tpu_torch.ops import icp
from dpg_slam_tpu_torch.parallel.mesh import Mesh
from dpg_slam_tpu_torch.parallel.partition import spatial_blocks
from dpg_slam_tpu_torch.parallel.schur import full_graph, robust_between_error, schur_solve

__all__ = ["sharded_icp_align", "distributed_solve", "distributed_reoptimize", "separator_cap"]

_log = logging.getLogger("dpg_slam_tpu_torch.parallel")


def sharded_icp_align(
    mesh: Mesh, src, src_mask, tgt, tgt_mask, init_guess, params: PoseGraphParams, **kwargs,
) -> icp.ICPResult:
    """Batched ICP with the pair axis split over the mesh's shards. The
    pair count must be divisible by the mesh size (pad with masked pairs
    otherwise)."""
    B = src.shape[0]
    if B % mesh.size != 0:
        raise ValueError(f"pair count {B} not divisible by mesh size {mesh.size}")
    return icp.icp_align(src, src_mask, tgt, tgt_mask, init_guess, params, **kwargs)


def _local_normal_contrib(poses, g_loc: fg.FactorGraph, edge_mask_l, S: int, plan, pJ, pr, robust_delta=None):
    """Per-shard normal equations from each shard's own edges and the
    replicated priors' 1 / S shares (pJ, pr already masked): diag
    (S, N, 3, 3), off (S, El, 3, 3), rhs (S, N, 3). plan sums the `i`
    ends, the `j` ends and then the priors of every shard into its node
    slots (shard s at offset s·N)."""
    N = poses.shape[0]
    El = edge_mask_l.shape[1]
    er, Ji, Jj = fg._between_residual_jac(poses, g_loc)
    em = edge_mask_l.reshape(-1).to(poses.dtype)
    if robust_delta is not None:
        em = em * torch.sqrt(fg._huber_weight(er, robust_delta))
    Ji = Ji * em[:, None, None]
    Jj = Jj * em[:, None, None]
    er = er * em[:, None]
    inv_n = 1.0 / S
    prior_h = (inv_n * (pJ.transpose(-1, -2) @ pJ))[None].expand(S, -1, -1, -1).reshape(-1, 3, 3)
    prior_g = (inv_n * torch.einsum("pba,pb->pa", pJ, pr))[None].expand(S, -1, -1).reshape(-1, 3)
    diag = segment_sum(torch.cat([Ji.transpose(-1, -2) @ Ji, Jj.transpose(-1, -2) @ Jj, prior_h]), plan)
    rhs = segment_sum(torch.cat([torch.einsum("eba,eb->ea", Ji, er), torch.einsum("eba,eb->ea", Jj, er), prior_g]),
                      plan)
    off = (Ji.transpose(-1, -2) @ Jj).view(S, El, 3, 3)
    return diag.view(S, N, 3, 3), off, rhs.view(S, N, 3)


def distributed_solve(
    mesh: Mesh,
    poses: torch.Tensor,           # (N, 3)
    node_mask: torch.Tensor,       # (N,)
    prior_idx: torch.Tensor,       # (Pr,)
    prior_val: torch.Tensor,       # (Pr, 3)
    prior_sqrt_info: torch.Tensor, # (Pr, 3, 3)
    prior_mask: torch.Tensor,      # (Pr,)
    edge_idx: torch.Tensor,        # (E, 2), E divisible by the mesh size
    edge_meas: torch.Tensor,       # (E, 3)
    edge_sqrt_info: torch.Tensor,  # (E, 3, 3)
    edge_mask: torch.Tensor,       # (E,)
    *,
    max_iterations: int = 15,
    cg_iterations: int = 48,
    damping: float = 1e-4,
    robust_delta: float | None = None,
    rel_tol: float = 0.0,
) -> torch.Tensor:
    """Levenberg-Marquardt with edge-sharded PCG (fixed cg_iterations):
    Huber IRLS when ``robust_delta`` is set, accept/reject against the
    robust total error with adaptive damping, early stop once an accepted
    step improves the error by less than ``rel_tol``. Returns the poses."""
    S = mesh.size
    N = poses.shape[0]
    E = edge_idx.shape[0]
    if E % S != 0:
        raise ValueError(f"edge capacity {E} must be divisible by mesh size {S}")
    if poses.device.type != mesh.device.type:
        raise ValueError(f"poses on {poses.device}, mesh on {mesh.device}")
    dt, dev = poses.dtype, poses.device
    El = E // S
    g = full_graph(prior_idx, prior_val, prior_sqrt_info, prior_mask,
                   edge_idx, edge_meas, edge_sqrt_info, edge_mask)
    edge_mask_l = edge_mask.view(S, El)
    emf = edge_mask.to(dt)[:, None]
    pm = prior_mask.to(dt)
    base = (torch.arange(S, device=dev) * N).repeat_interleave(El)
    i_loc = base + g.edge_idx[:, 0].long()
    j_loc = base + g.edge_idx[:, 1].long()
    i_glob = g.edge_idx[:, 0].long()
    j_glob = g.edge_idx[:, 1].long()
    p_loc = ((torch.arange(S, device=dev) * N)[:, None] + g.prior_idx.long()).reshape(-1)
    # The index sets are fixed for the solve: sorted once here, masked
    # slots dropped.
    i_live, j_live = (torch.where(edge_mask, x, S * N) for x in (i_loc, j_loc))
    p_live = torch.where(prior_mask.repeat(S), p_loc, S * N)
    normal_plan = segment_plan(torch.cat([i_live, j_live, p_live]), S * N)
    matvec_plan = segment_plan(torch.cat([i_live, j_live]), S * N)
    eye = torch.eye(3, dtype=dt, device=dev)

    def robust_error(p):
        er, _, _ = fg._between_residual_jac(p, g)
        pr, _ = fg._prior_residual_jac(p, g)
        pr = pr * pm[:, None]
        per_shard = torch.stack([
            robust_between_error(e, robust_delta) for e in (er * emf).view(S, El, 3)
        ])
        return 0.5 * torch.sum(pr * pr) + per_shard.sum()

    def one_gn_step(p, damping_c):
        pr, pJ = fg._prior_residual_jac(p, g)
        diag_l, off_l, rhs_l = _local_normal_contrib(
            p, g, edge_mask_l, S, normal_plan, pJ * pm[:, None, None], pr * pm[:, None], robust_delta)
        diag = diag_l.sum(0)
        rhs = rhs_l.sum(0)
        diag = torch.where(node_mask[:, None, None], diag, eye)
        rhs = torch.where(node_mask[:, None], rhs, 0.0)
        diag = diag + damping_c * eye
        Minv = geom.inv_sym3(diag)
        off = off_l.reshape(E, 3, 3)

        def matvec(v):
            loc = segment_sum(torch.cat([emf * torch.einsum("eab,eb->ea", off, v[j_glob]),
                                         emf * torch.einsum("eba,eb->ea", off, v[i_glob])]), matvec_plan)
            return torch.einsum("nab,nb->na", diag, v) + loc.view(S, N, 3).sum(0)

        def precond(v):
            return torch.einsum("nab,nb->na", Minv, v)

        x = torch.zeros_like(rhs)
        r = rhs - matvec(x)
        z = precond(r)
        d = z
        rz = torch.sum(r * z)
        for _ in range(cg_iterations):
            Ad = matvec(d)
            denom = torch.sum(d * Ad)
            alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
            x = x + alpha * d
            r = r - alpha * Ad
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
            d = z + beta * d
            rz = rz_new
        new = p - x
        return torch.cat([new[:, :2], geom.wrap_angle(new[:, 2:3])], dim=1)

    err = robust_error(poses)
    damping_c = torch.tensor(damping, dtype=dt, device=dev)
    it = 0
    done = False
    while it < max_iterations and not done:
        cand = one_gn_step(poses, damping_c)
        cand_err = robust_error(cand)
        accept = bool(cand_err < err)
        if rel_tol > 0.0:
            done = accept and bool((err - cand_err) / torch.clamp(err, min=1e-12) < rel_tol)
        if accept:
            poses, err = cand, cand_err
        damping_c = torch.clamp(damping_c * (0.5 if accept else 4.0), 1e-9, 1e6)
        it += 1
    return poses


def separator_cap(N: int) -> int:
    """The reoptimize's separator capacity at N node slots: small graphs
    keep every node as a possible separator, large ones half of them
    (boundary crossings scale with shards x traversals, not N)."""
    return N if N <= 128 else max(128, -(-N // 2 // 8) * 8)


def distributed_reoptimize(mesh: Mesh, cfg, state, solver: str = "auto", pallas_elimination: bool = False):
    """Pass-boundary reoptimize over the mesh (the JAX package's multi-chip
    reoptimize): the live successive and loop-closure ICP pairs, compacted
    on the host and padded to a multiple of lcm(64, S); the factor graph
    rebuilt; then the distributed solve. ``solver``:

    - "schur": Schur elimination over a spatial node partition
      (parallel/partition.py); ``pallas_elimination`` eliminates the
      interiors with kernel K2 on the card;
    - "cg": edge-sharded PCG;
    - "auto": Schur when every shard gets at least 4 node slots, else CG.
      A separator overflow falls back to CG with a warning.

    Runs at the state's full node capacity. Returns the updated state
    (poses and rebuilt graph).
    """
    from dpg_slam_tpu_torch import engine as eng_mod

    pg = cfg.pose_graph
    S = mesh.size
    N = state.poses.shape[0]
    K = pg.max_loop_closures_per_node
    dev = state.poses.device
    if dev.type != mesh.device.type:
        raise ValueError(f"state on {dev}, mesh on {mesh.device}")

    flat_src, flat_tgt, flat_valid, seeds, flat_gate = eng_mod._reoptimize_pairs(cfg, state)
    n_flat = flat_src.shape[0]

    node_mask = state.node_mask
    poses_h = state.poses.cpu().numpy()
    valid_h = eng_mod._reoptimize_valid_host(cfg, poses_h, state.pass_ids.cpu().numpy(), node_mask.cpu().numpy())
    live = np.nonzero(valid_h)[0]
    is_succ = (live % (1 + K)) == 0
    order = np.concatenate([live[is_succ], live[~is_succ]])
    blk = 64 * S // math.gcd(64, S)
    B = max(blk, -(-len(order) // blk) * blk)
    compact_idx = np.zeros((B,), np.int64)
    compact_idx[: len(order)] = order
    compact_valid = np.zeros((B,), bool)
    compact_valid[: len(order)] = True
    _log.info("distributed_reoptimize: compacted ICP sweep %d live pairs (padded %d) of %d flat slots",
              len(order), B, n_flat)
    ci = torch.as_tensor(compact_idx, device=dev)
    cval = torch.as_tensor(compact_valid, device=dev) & flat_valid[ci]
    csrc, ctgt = flat_src[ci], flat_tgt[ci]

    res = sharded_icp_align(
        mesh,
        state.cloud[csrc],
        state.cloud_mask[csrc] & cval[:, None],
        state.cloud[ctgt],
        state.cloud_mask[ctgt] & cval[:, None],
        seeds[ci],
        pg,
        tgt_normals=state.cloud_normals[ctgt],
        gate_multiplier=flat_gate[ci],
    )

    # Back to flat order; slots not swept keep the seed, not converged, and
    # the fixed covariance.
    live_t = ci[cval]
    transforms = seeds.clone()
    transforms[live_t] = res.transform[cval]
    converged = torch.zeros((n_flat,), dtype=torch.bool, device=dev)
    converged[live_t] = res.converged[cval]
    fixed = torch.tensor([pg.laser_x_variance, pg.laser_y_variance, pg.laser_theta_variance],
                         dtype=torch.float32, device=dev)
    covs = torch.diag(fixed).expand(n_flat, 3, 3).clone()
    covs[live_t] = res.covariance[cval]

    graph, n_edge_cand = eng_mod._reoptimize_pack_graph(
        cfg, state, flat_src, flat_tgt, flat_valid, transforms, converged, covs
    )
    E = graph.edge_idx.shape[0]
    if int(n_edge_cand) > E:
        raise RuntimeError(
            f"reoptimize produced {int(n_edge_cand)} factor candidates but "
            f"edge capacity is {E}; raise CapacityParams.max_edges"
        )
    factors = (graph.prior_idx, graph.prior_val, graph.prior_sqrt_info, graph.prior_mask,
               graph.edge_idx, graph.edge_meas, graph.edge_sqrt_info, graph.edge_mask)
    max_it = min(pg.gn_max_iterations, pg.gtsam_max_iterations)

    use_schur = solver == "schur" or (solver == "auto" and N % S == 0 and N // S >= 4)
    if use_schur:
        assign = spatial_blocks(poses_h[:, :2], node_mask.cpu().numpy(), S)
        sep_cap = separator_cap(N)
        poses, sep_count, _ = schur_solve(
            mesh, state.poses, node_mask, *factors, torch.as_tensor(assign, device=dev),
            sep_cap=sep_cap, max_iterations=max_it, robust_delta=pg.robust_delta,
            rel_tol=pg.gn_tol, pallas_elimination=pallas_elimination,
        )
        if sep_count > sep_cap:
            _log.warning("schur separator overflow (%d > cap %d); falling back to edge-sharded CG",
                         sep_count, sep_cap)
            use_schur = False
    if not use_schur:
        poses = distributed_solve(
            mesh, state.poses, node_mask, *factors,
            max_iterations=max_it, robust_delta=pg.robust_delta, rel_tol=pg.gn_tol,
        )
    return state._replace(poses=poses, graph=graph)
