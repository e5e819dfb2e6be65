"""Batched 2D ICP with closed-form covariance — the port of
dpg_slam_tpu/ops/icp.py.

``icp_align`` picks its path from the config and the tensor's device,
before anything is launched:
  * point-to-line without RANSAC rejection (every default path) on a CUDA
    tensor launches the hand-written kernel (ops/icp_cuda.py,
    csrc/icp_kernel.cu), which runs the whole iteration loop per pair. A
    kernel that cannot build or launch raises: nothing falls back;
  * every other call runs the plain PyTorch version below
    (``_icp_align_impl``, the JAX package's XLA array program: a (B, P, P)
    squared-distance matrix, a one-hot match matrix, one damped
    Gauss-Newton step per iteration). That is the CPU's path, and on the
    card the path of the configs the kernel does not implement, RANSAC
    correspondence rejection and point-to-point residuals, as the JAX
    package keeps those on its XLA path (its engine's _kernel_config).
The plain version is device-agnostic, so it is also what the kernel is
held against on the card.

RANSAC draws its 2-point samples from a torch.Generator seeded 17 (the JAX
package's PRNG key) on the CPU, for every iteration at once
(``ransac_samples``), and moves them to the tensors' device, so the card
and the CPU use the same samples; ``icp_align(..., ransac_samples=...)``
takes them from the caller instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.config import PoseGraphParams
from dpg_slam_tpu_torch.utils import profiling

__all__ = ["ICPResult", "censi_covariance", "estimate_normals", "icp_align", "ransac_samples"]

_BIG = 1e12
_DAMPING = 1e-3


class ICPResult(NamedTuple):
    """Batched ICP outputs (see the JAX package's ICPResult).

    transform (B, 3) pose of the source frame in the target frame;
    converged (B,) bool acceptance; num_correspondences (B,) int32;
    fitness (B,) mean squared correspondence distance; overlap (B,)
    matched fraction of valid source points; covariance (B, 3, 3).
    """

    transform: torch.Tensor
    converged: torch.Tensor
    num_correspondences: torch.Tensor
    fitness: torch.Tensor
    overlap: torch.Tensor
    covariance: torch.Tensor


def estimate_normals(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-point unit normals from the ordered scan: perpendicular of
    p[i+1] - p[i-1] (one-sided where a neighbour is invalid, radial when
    both are); zeros where the point itself is invalid."""
    nxt = torch.roll(points, -1, dims=-2)
    prv = torch.roll(points, 1, dims=-2)
    nxt_ok = torch.roll(mask, -1, dims=-1)[..., None]
    prv_ok = torch.roll(mask, 1, dims=-1)[..., None]
    tangent = torch.where(
        nxt_ok & prv_ok,
        nxt - prv,
        torch.where(nxt_ok, nxt - points, torch.where(prv_ok, points - prv, points)),
    )
    normal = torch.stack([-tangent[..., 1], tangent[..., 0]], dim=-1)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    radial = points / torch.clamp(torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-6)
    unit = torch.where(norm > 1e-6, normal / torch.clamp(norm, min=1e-6), radial)
    return torch.where(mask[..., None], unit, 0.0)


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, P, 2), (B, Q, 2) -> (B, P, Q) squared distances as dx² + dy².

    The JAX package's XLA path forms |a|² + |b|² - 2 a·b so the cross term
    lands on the TPU's matrix unit; in float32 that cancels |p|² (up to
    ~100 m² at 10 m range) down to errors of ~1e-5 m², enough to flip
    near-tied nearest neighbours. The direct form is exact to rounding and
    is the form the kernel (and the Pallas kernel) computes, so kernel and
    plain version pick the same neighbours."""
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    return dx * dx + dy * dy


def _matches(moved, src_mask, tgt, tgt_mask, gate_sq, reciprocal):
    """Row-normalized one-hot match matrix (tie-inclusive nearest target,
    optional mutual-NN test, gate) plus per-source nn distance and the
    correspondence weight mask."""
    d2 = _pairwise_sqdist(moved, tgt)
    d2 = torch.where(src_mask[:, :, None], d2, _BIG)
    d2 = torch.where(tgt_mask[:, None, :], d2, _BIG)
    rowmin = torch.amin(d2, dim=-1, keepdim=True)
    M = d2 <= rowmin
    if reciprocal:
        M = M & (d2 <= torch.amin(d2, dim=-2, keepdim=True))
    M = M & (d2 <= gate_sq[:, None, None])
    Mf = M.to(torch.float32)
    row_cnt = torch.sum(Mf, dim=-1)
    w = src_mask & (row_cnt > 0)
    Mn = Mf / torch.clamp(row_cnt, min=1.0)[..., None]
    return Mn, rowmin[..., 0], w


def censi_sums(
    src, src_mask, tgt, tgt_mask, transform, *, max_correspondence_distance, reciprocal
) -> torch.Tensor:
    """The 8 per-pair sums the Censi sandwich is assembled from, evaluated
    at ``transform`` on point-to-point correspondences at the fine gate:
    (B, 8) = [n, su_x, su_y, htt, q_tt, srv1, srv2, p_tt] — the same
    accumulators the kernel returns in columns 12..19."""
    B = src.shape[0]
    moved = geom.apply(transform[:, None, :], src)
    gate_sq = torch.full((B,), max_correspondence_distance**2, dtype=src.dtype, device=src.device)
    Mn, _, w = _matches(moved, src_mask, tgt, tgt_mask, gate_sq, reciprocal)
    wf = w.to(torch.float32)
    q = torch.einsum("bpq,bqc->bpc", Mn, tgt)
    r = (moved - q) * wf[..., None]
    rp = moved - transform[:, None, 0:2]                       # R p_i
    u = torch.stack([-rp[..., 1], rp[..., 0]], dim=-1) * wf[..., None]  # R' p_i
    n_corr = torch.sum(wf, dim=-1)
    su = torch.sum(u, dim=-2)
    uu = torch.sum(u * u, dim=-1)
    htt = torch.sum(uu - torch.sum(r * rp, dim=-1), dim=-1)
    q_tt = torch.sum(uu, dim=-1)
    c = torch.cos(transform[:, 2])[:, None]
    s = torch.sin(transform[:, 2])[:, None]
    v1 = c * u[..., 0] + s * u[..., 1] - s * r[..., 0] + c * r[..., 1]
    v2 = -s * u[..., 0] + c * u[..., 1] - c * r[..., 0] - s * r[..., 1]
    rv1 = c * v1 - s * v2
    rv2 = s * v1 + c * v2
    return torch.stack(
        [
            n_corr, su[:, 0], su[:, 1], htt, q_tt,
            torch.sum(rv1, dim=-1), torch.sum(rv2, dim=-1),
            torch.sum(v1 * v1 + v2 * v2, dim=-1),
        ],
        dim=-1,
    )


def censi_from_sums(sums: torch.Tensor, src_noise_std: float, tgt_noise_std: float) -> torch.Tensor:
    """Assemble H^-1 S H^-1 (cov_func_point_to_point.h:530-556 analog)
    from censi_sums' accumulators; pairs with < 3 matches get 1e6·I."""
    c_n, su_x, su_y, htt, q_tt, srv1, srv2, p_tt = sums.unbind(-1)
    zero = torch.zeros_like(c_n)

    def sym3(a, b, tt):
        return torch.stack(
            [
                torch.stack([c_n, zero, a], dim=-1),
                torch.stack([zero, c_n, b], dim=-1),
                torch.stack([a, b, tt], dim=-1),
            ],
            dim=-2,
        )

    H = 2.0 * sym3(su_x, su_y, htt)
    Sq = 4.0 * sym3(su_x, su_y, q_tt)
    Sp = 4.0 * sym3(srv1, srv2, p_tt)
    S = src_noise_std**2 * Sp + tgt_noise_std**2 * Sq
    ok = (c_n >= 3.0)[:, None, None]
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = geom.inv_sym3(torch.where(ok, H, eye))
    cov = torch.einsum("bij,bjk,bkl->bil", Hinv, S, Hinv)
    return torch.where(ok, cov, 1e6 * eye)


def censi_covariance(
    src, src_mask, tgt, tgt_mask, transform, *,
    max_correspondence_distance, reciprocal, src_noise_std, tgt_noise_std,
) -> torch.Tensor:
    """Full Censi closed-form ICP covariance at the final transform (see
    the JAX package's censi_covariance for the derivation)."""
    sums = censi_sums(
        src, src_mask, tgt, tgt_mask, transform,
        max_correspondence_distance=max_correspondence_distance, reciprocal=reciprocal,
    )
    return censi_from_sums(sums, src_noise_std, tgt_noise_std)


class _IterState(NamedTuple):
    transform: torch.Tensor  # (B, 3)
    active: torch.Tensor     # (B,) bool
    hessian: torch.Tensor    # (B, 3, 3) last damped normal matrix
    num_corr: torch.Tensor   # (B,) int32
    fitness: torch.Tensor    # (B,)


def _ransac_keep(moved, q, w, idx, threshold):
    """RANSAC correspondence rejection (the JAX package's _icp_iteration,
    PCL's setRANSACIterations analog): per pair, a rigid model from each
    of R 2-point samples idx (B, R, 2) of the correspondences, scored by
    its inlier count under `threshold`; the correspondences the best model
    leaves out are dropped, unless it has fewer than 3 inliers. Returns
    the (B, P) mask to keep."""
    B, R, _ = idx.shape

    def take(pts, k):  # (B, R, 2): the sampled points
        return torch.gather(pts, 1, idx[..., k, None].expand(B, R, 2))

    a1, b1, a2, b2 = take(moved, 0), take(q, 0), take(moved, 1), take(q, 1)
    va, vb = a2 - a1, b2 - b1
    sample_ok = (
        torch.gather(w, 1, idx[..., 0]) & torch.gather(w, 1, idx[..., 1])
        & (torch.sum(va * va, dim=-1) > 1e-6) & (torch.sum(vb * vb, dim=-1) > 1e-6)
    )
    ang = torch.atan2(vb[..., 1], vb[..., 0]) - torch.atan2(va[..., 1], va[..., 0])
    cs, sn = torch.cos(ang), torch.sin(ang)
    tx = b1[..., 0] - (cs * a1[..., 0] - sn * a1[..., 1])
    ty = b1[..., 1] - (sn * a1[..., 0] + cs * a1[..., 1])
    mx, my = moved[:, None, :, 0], moved[:, None, :, 1]
    rx = cs[..., None] * mx - sn[..., None] * my + tx[..., None] - q[:, None, :, 0]
    ry = sn[..., None] * mx + cs[..., None] * my + ty[..., None] - q[:, None, :, 1]
    inlier = (rx * rx + ry * ry <= threshold**2) & w[:, None, :]
    count = torch.where(sample_ok, torch.sum(inlier, dim=-1), -1)  # (B, R)
    best = torch.argmax(count, dim=-1)                              # the first best, as jnp.argmax
    best_inliers = torch.gather(inlier, 1, best[:, None, None].expand(B, 1, inlier.shape[-1]))[:, 0]
    best_count = torch.gather(count, 1, best[:, None])[:, 0]
    return torch.where((best_count >= 3)[:, None], best_inliers, True)


def _icp_iteration(
    state: _IterState, src, src_mask, tgt, tgt_mask, tgt_normals, *,
    max_corr_sq, reciprocal, epsilon, error_delta_rel_tol, point_to_line=True,
    ransac_idx=None, ransac_threshold=0.05,
) -> _IterState:
    """One damped Gauss-Newton step for every pair: point-to-line (one
    residual a point along the target normal) or point-to-point (two rows
    a point), with RANSAC rejection of the correspondences first when
    ransac_idx (B, R, 2) gives its samples."""
    moved = geom.apply(state.transform[:, None, :], src)
    Mn, nn_d2, w = _matches(moved, src_mask, tgt, tgt_mask, max_corr_sq, reciprocal)
    q = torch.einsum("bpq,bqc->bpc", Mn, tgt)
    if ransac_idx is not None:
        w = w & _ransac_keep(moved, q, w, ransac_idx, ransac_threshold)
    wf = w.to(torch.float32)

    err = moved - q
    rp = moved - state.transform[:, None, 0:2]
    drot = torch.stack([-rp[..., 1], rp[..., 0]], dim=-1)
    if point_to_line:
        n = torch.einsum("bpq,bqc->bpc", Mn, tgt_normals)
        r = torch.sum(n * err, dim=-1)
        J = torch.cat([n, torch.sum(n * drot, dim=-1, keepdim=True)], dim=-1)
        H = torch.einsum("bpi,bpj->bij", J * wf[..., None], J)
        g = torch.einsum("bpi,bp->bi", J * wf[..., None], r)
    else:
        # Rows J_x = [1, 0, drot_x], J_y = [0, 1, drot_y] on r = moved - q.
        hxx = torch.sum(wf, dim=-1)
        hxt = torch.sum(wf * drot[..., 0], dim=-1)
        hyt = torch.sum(wf * drot[..., 1], dim=-1)
        htt = torch.sum(wf * torch.sum(drot * drot, dim=-1), dim=-1)
        zero = torch.zeros_like(hxx)
        H = torch.stack([
            torch.stack([hxx, zero, hxt], dim=-1),
            torch.stack([zero, hxx, hyt], dim=-1),
            torch.stack([hxt, hyt, htt], dim=-1),
        ], dim=-2)
        g = torch.stack([
            torch.sum(wf * err[..., 0], dim=-1),
            torch.sum(wf * err[..., 1], dim=-1),
            torch.sum(wf * torch.sum(drot * err, dim=-1), dim=-1),
        ], dim=-1)

    num_corr = torch.sum(w, dim=-1).to(torch.int32)
    fitness = torch.sum(wf * nn_d2, dim=-1) / torch.clamp(num_corr.to(torch.float32), min=1.0)

    # Trace-relative damping pins directions the geometry leaves
    # unconstrained (corridors) to the seed.
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    tr = (H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]) / 3.0
    lam = _DAMPING * torch.clamp(tr, min=1e-12)
    Hd = H + lam[:, None, None] * eye
    solvable = (num_corr >= 3)[:, None]
    Hinv = geom.inv_sym3(torch.where(solvable[..., None], Hd, eye))
    delta = torch.where(solvable, torch.einsum("bij,bj->bi", Hinv, g), 0.0)

    step = torch.where(state.active[:, None], -delta, 0.0)
    new_t = state.transform + step
    new_t = torch.cat([new_t[:, :2], geom.wrap_angle(new_t[:, 2:3])], dim=-1)

    still = state.active & (torch.sum(step * step, dim=-1) > epsilon)
    if error_delta_rel_tol > 0.0:
        # Freeze pairs whose fitness stopped improving (the first
        # iteration's carried fitness is inf, so it never stalls).
        stalled = torch.isfinite(state.fitness) & (
            (state.fitness - fitness).abs()
            <= error_delta_rel_tol * torch.clamp(fitness, min=1e-12)
        )
        still = still & ~stalled
    return _IterState(new_t, still, Hd, num_corr, fitness)


def ransac_samples(params: PoseGraphParams, B: int, P: int, device) -> torch.Tensor:
    """RANSAC's sample indices for every iteration of one icp_align call
    on B pairs of P source points: (icp_maximum_iterations, B,
    ransac_iterations, 2) int32 in [0, P), drawn on the CPU from a
    torch.Generator seeded 17 (the JAX package's PRNG key; the JAX package
    draws jax.random.randint(fold_in(key, it), (B, R, 2), 0, P) an
    iteration instead), then moved to `device`."""
    gen = torch.Generator().manual_seed(17)
    shape = (params.icp_maximum_iterations, B, params.ransac_iterations, 2)
    return torch.randint(0, P, shape, generator=gen, dtype=torch.int32).to(device)


def anneal_length(params: PoseGraphParams) -> int:
    """Coarse-to-fine annealing length in iterations (icp_anneal_iters,
    or the legacy 2/3 · max_iterations rule when None)."""
    max_it = params.icp_maximum_iterations
    if params.icp_anneal_iters is not None:
        return max(1, min(params.icp_anneal_iters, max_it))
    return max(1, (2 * max_it) // 3)


def _icp_align_impl(
    src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier,
    params: PoseGraphParams, ransac_idx=None,
):
    """Plain PyTorch ICP loop (the JAX package's _icp_align_impl as a
    Python loop). Returns (transform, num_corr, fitness, hessian) — the
    same quantities the kernel's output row carries. With RANSAC on,
    ransac_idx holds its samples, (iterations, B, R, 2) (default
    ransac_samples)."""
    B = src.shape[0]
    dev = src.device
    state = _IterState(
        transform=init_guess,
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        hessian=torch.eye(3, device=dev).expand(B, 3, 3),
        num_corr=torch.zeros((B,), dtype=torch.int32, device=dev),
        fitness=torch.full((B,), float("inf"), device=dev),
    )
    anneal_iters = anneal_length(params)
    max_corr = params.icp_max_correspondence_distance
    annealed = gate_multiplier > 1.0
    if params.icp_use_ransac_rejection and ransac_idx is None:
        ransac_idx = ransac_samples(params, B, src.shape[1], dev)
    modes = dict(point_to_line=params.icp_point_to_line,
                 ransac_threshold=params.ransac_outlier_rejection_threshold)
    it = 0
    # Early exit once every pair has frozen (annealing pairs are held
    # active through their schedule, so this can only trip after it).
    while it < params.icp_maximum_iterations and bool(state.active.any()):
        # f32 schedule arithmetic, as the JAX loop's float32 counter does.
        progress = np.maximum(
            np.float32(0.0), np.float32(1.0) - np.float32(it) / np.float32(anneal_iters)
        )
        mult = 1.0 + (gate_multiplier - 1.0) * float(progress)
        state = _icp_iteration(
            state, src, src_mask, tgt, tgt_mask, tgt_normals,
            max_corr_sq=(max_corr * mult) ** 2,
            reciprocal=params.icp_use_reciprocal_correspondences,
            epsilon=params.icp_maximum_transformation_epsilon,
            error_delta_rel_tol=params.icp_error_delta_rel_tol,
            ransac_idx=None if ransac_idx is None else ransac_idx[it].long(), **modes,
        )
        # Held through the last still-coarse iteration so exit statistics
        # are always taken at the fine gate.
        state = state._replace(active=state.active | (annealed & (it < anneal_iters)))
        it += 1
    # Exit statistics of every pair at its final transform and the fine
    # gate, as the kernel evaluates them. (The JAX loop reports each pair's
    # statistics from the batch's last iteration: at the final transform
    # for a pair frozen earlier, one step before it for a pair still moving
    # then — a dependence on the batch this definition drops.) RANSAC takes
    # the last iteration's samples, as the JAX loop's statistics do.
    final = _icp_iteration(
        state._replace(active=torch.zeros_like(state.active)),
        src, src_mask, tgt, tgt_mask, tgt_normals,
        max_corr_sq=torch.full_like(gate_multiplier, max_corr) ** 2,
        reciprocal=params.icp_use_reciprocal_correspondences,
        epsilon=params.icp_maximum_transformation_epsilon,
        error_delta_rel_tol=0.0,
        ransac_idx=None if ransac_idx is None else ransac_idx[it - 1].long(), **modes,
    )
    return state.transform, final.num_corr, final.fitness, final.hessian


def accept_and_covariance(
    transform, num_corr, fitness, hessian, censi, *,
    src_mask, init_guess, gate_multiplier, params: PoseGraphParams,
    min_correspondences, fitness_threshold, min_overlap, sensor_noise_std,
) -> ICPResult:
    """Acceptance gates (matches, fitness, overlap, seed deviation) and the
    observation covariance (fixed diagonal / GN 2σ²H⁻¹ / Censi sandwich
    from its sums, plus the floor), shared by the plain version and the
    kernel's host-side wrapper. ``censi`` is the (B, 8) sums tensor in
    Censi mode, else None."""
    n_src_valid = torch.sum(src_mask, dim=-1).to(torch.float32)
    overlap = num_corr.to(torch.float32) / torch.clamp(n_src_valid, min=1.0)
    deviation = torch.linalg.norm(transform[:, 0:2] - init_guess[:, 0:2], dim=-1)
    converged = (
        (num_corr >= min_correspondences)
        & (fitness <= fitness_threshold)
        & (overlap >= min_overlap)
        & (deviation <= gate_multiplier * params.icp_max_correspondence_distance)
    )
    dev = transform.device
    fallback = torch.diag(
        geom.constant([params.laser_x_variance, params.laser_y_variance, params.laser_theta_variance], dev)
    )
    B = transform.shape[0]
    if params.use_fixed_icp_covariance:
        cov = fallback.expand(B, 3, 3)
    else:
        if censi is not None:
            cov = censi_from_sums(censi, sensor_noise_std, sensor_noise_std)
        else:
            eye = torch.eye(3, dtype=hessian.dtype, device=dev)
            safe_H = torch.where(converged[:, None, None], hessian, eye)
            cov = 2.0 * (sensor_noise_std**2) * geom.inv_sym3(safe_H)
        ft, fr = params.icp_cov_floor_transl**2, params.icp_cov_floor_rot**2
        cov = cov + torch.diag(geom.constant([ft, ft, fr], dev))
        cov = torch.where(converged[:, None, None], cov, fallback)
    return ICPResult(transform, converged, num_corr, fitness, overlap, cov)


def is_censi_mode(params: PoseGraphParams) -> bool:
    return not params.use_fixed_icp_covariance and params.icp_covariance_mode == "censi"


def icp_align_plain(
    src, src_mask, tgt, tgt_mask, init_guess, params: PoseGraphParams, *,
    tgt_normals, gate_multiplier, min_correspondences, fitness_threshold,
    min_overlap, sensor_noise_std, ransac_samples=None,
) -> ICPResult:
    """The plain PyTorch version of kernel K1 with its host-side wrapper,
    on any device (icp_align picks it for CPU tensors, and for the configs
    K1 does not implement)."""
    transform, num_corr, fitness, hessian = _icp_align_impl(
        src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier, params, ransac_samples
    )
    censi = None
    if is_censi_mode(params):
        censi = censi_sums(
            src, src_mask, tgt, tgt_mask, transform,
            max_correspondence_distance=params.icp_max_correspondence_distance,
            reciprocal=params.icp_use_reciprocal_correspondences,
        )
    return accept_and_covariance(
        transform, num_corr, fitness, hessian, censi,
        src_mask=src_mask, init_guess=init_guess, gate_multiplier=gate_multiplier,
        params=params, min_correspondences=min_correspondences,
        fitness_threshold=fitness_threshold, min_overlap=min_overlap,
        sensor_noise_std=sensor_noise_std,
    )


def icp_align(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_guess: torch.Tensor,
    params: PoseGraphParams,
    tgt_normals: torch.Tensor | None = None,
    gate_multiplier: torch.Tensor | None = None,
    min_correspondences: int = 10,
    fitness_threshold: float = 0.25,
    min_overlap: float | None = None,
    sensor_noise_std: float | None = None,
    ransac_samples: torch.Tensor | None = None,
) -> ICPResult:
    """Align a batch of source clouds onto target clouds (the JAX
    package's icp_align interface).

    src (B, Ps, 2) and tgt (B, Pt, 2) float32, masks (B, Ps) and (B, Pt)
    bool, init_guess (B, 3) seed
    pose of src in tgt's frame, gate_multiplier (B,) per-pair coarse gate
    (default: the configured coarse multiplier for every pair).
    ransac_samples (icp_maximum_iterations, B, ransac_iterations, 2)
    source indices: RANSAC's samples, when it is on (default:
    ops.icp.ransac_samples' draw).

    The call is the span icp.align and adds B to the counter k1.pairs
    (utils.profiling).
    """
    profiling.count("k1.pairs", src.shape[0])
    with profiling.span("icp.align"):
        if tgt_normals is None:
            tgt_normals = estimate_normals(tgt, tgt_mask)
        if sensor_noise_std is None:
            sensor_noise_std = params.icp_sensor_noise_std
        if min_overlap is None:
            min_overlap = params.icp_min_overlap
        if gate_multiplier is None:
            gate_multiplier = torch.full(
                (src.shape[0],), params.icp_coarse_gate_multiplier,
                dtype=torch.float32, device=src.device,
            )
        kwargs = dict(
            tgt_normals=tgt_normals, gate_multiplier=gate_multiplier,
            min_correspondences=min_correspondences, fitness_threshold=fitness_threshold,
            min_overlap=min_overlap, sensor_noise_std=sensor_noise_std,
        )
        if src.device.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"no ICP path for device {src.device}")
        if src.device.type == "cuda" and params.icp_point_to_line and not params.icp_use_ransac_rejection:
            from dpg_slam_tpu_torch.ops.icp_cuda import icp_align_cuda

            return icp_align_cuda(src, src_mask, tgt, tgt_mask, init_guess, params, **kwargs)
        return icp_align_plain(src, src_mask, tgt, tgt_mask, init_guess, params, ransac_samples=ransac_samples,
                               **kwargs)
