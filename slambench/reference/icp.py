"""Plain point-to-line ICP: the batched loop that kernel K1 runs per pair,
written as dense tensor work (a (B, Ps, Pt) distance matrix, a one-hot
match matrix, one damped Gauss-Newton step an iteration), with the
acceptance gates and the Gauss-Newton covariance.

Semantics (those of the reference DPG-SLAM frontend as the program
states them): tie-inclusive nearest target with the mutual-nearest test
when reciprocal correspondences are on; a coarse-to-fine gate that anneals
from gate_multiplier x the fine gate to the fine gate over the first
icp_anneal_iters iterations; trace-relative damping 1e-3; a pair freezes
once its step is below the epsilon or its fitness stops improving; exit
statistics at the final transform and the fine gate; the covariance
2 sigma^2 H^-1 of the last damped normal matrix. `rnd` rounds the
operands of every product (exact: float32; geom.tf32: the control).
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import geom

_BIG = 1e12
_DAMPING = 1e-3
_CHUNK_ELEMS = 1 << 27  # (pairs x Ps x Pt) of one chunk


def _matches(moved, src_mask, tgt, tgt_mask, gate_sq, reciprocal):
    dx = moved[:, :, None, 0] - tgt[:, None, :, 0]
    dy = moved[:, :, None, 1] - tgt[:, None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(src_mask[:, :, None] & tgt_mask[:, None, :], d2, _BIG)
    rowmin = d2.amin(dim=-1, keepdim=True)
    M = d2 <= rowmin
    if reciprocal:
        M = M & (d2 <= d2.amin(dim=-2, keepdim=True))
    M = M & (d2 <= gate_sq[:, None, None])
    Mf = M.float()
    cnt = Mf.sum(-1)
    w = src_mask & (cnt > 0)
    return Mf / torch.clamp(cnt, min=1.0)[..., None], rowmin[..., 0], w


def _step(tf, active, fit_prev, src, src_mask, tgt, tgt_mask, nrm, gate_sq, pg, rnd, stall_tol):
    moved = geom.apply(tf, src)
    Mn, nn_d2, w = _matches(moved, src_mask, tgt, tgt_mask, gate_sq, pg.icp_use_reciprocal_correspondences)
    wf = w.float()
    q = torch.einsum("bpq,bqc->bpc", rnd(Mn), rnd(tgt))
    n = torch.einsum("bpq,bqc->bpc", rnd(Mn), rnd(nrm))
    err = moved - q
    rp = moved - tf[:, None, 0:2]
    r = (n * err).sum(-1)
    J = torch.cat([n, (n[..., 0] * -rp[..., 1] + n[..., 1] * rp[..., 0])[..., None]], dim=-1)
    Jw = rnd(J * wf[..., None])
    H = torch.einsum("bpi,bpj->bij", Jw, rnd(J))
    g = torch.einsum("bpi,bp->bi", Jw, rnd(r))
    num = w.sum(-1).to(torch.int32)
    fit = (wf * nn_d2).sum(-1) / torch.clamp(num.float(), min=1.0)
    eye = torch.eye(3, device=H.device)
    lam = _DAMPING * torch.clamp((H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]) / 3.0, min=1e-12)
    Hd = H + lam[:, None, None] * eye
    ok = (num >= 3)[:, None]
    Hinv = geom.inv3(torch.where(ok[..., None], Hd, eye))
    delta = torch.where(ok, torch.einsum("bij,bj->bi", rnd(Hinv), rnd(g)), 0.0)
    step = torch.where(active[:, None], -delta, 0.0)
    new = tf + step
    new = torch.cat([new[:, :2], geom.wrap(new[:, 2:3])], dim=-1)
    still = active & ((step * step).sum(-1) > pg.icp_maximum_transformation_epsilon)
    if stall_tol > 0.0:
        still = still & ~(torch.isfinite(fit_prev) & ((fit_prev - fit).abs() <= stall_tol * torch.clamp(fit, min=1e-12)))
    return new, still, Hd, num, fit


def _anneal_len(pg) -> int:
    m = pg.icp_maximum_iterations
    return max(1, min(pg.icp_anneal_iters, m)) if pg.icp_anneal_iters is not None else max(1, (2 * m) // 3)


def _align(src, src_mask, tgt, tgt_mask, nrm, init, gate, pg, rnd):
    B = src.shape[0]
    dev = src.device
    tf, active = init, torch.ones((B,), dtype=torch.bool, device=dev)
    fit = torch.full((B,), float("inf"), device=dev)
    anneal = _anneal_len(pg)
    fine = pg.icp_max_correspondence_distance
    annealed = gate > 1.0
    it = 0
    while it < pg.icp_maximum_iterations and bool(active.any()):
        prog = np.maximum(np.float32(0.0), np.float32(1.0) - np.float32(it) / np.float32(anneal))
        mult = 1.0 + (gate - 1.0) * float(prog)
        tf, active, _, _, fit = _step(tf, active, fit, src, src_mask, tgt, tgt_mask, nrm, (fine * mult) ** 2, pg,
                                      rnd, pg.icp_error_delta_rel_tol)
        active = active | (annealed & (it < anneal))
        it += 1
    _, _, Hd, num, fit = _step(tf, torch.zeros_like(active), fit, src, src_mask, tgt, tgt_mask, nrm,
                               torch.full_like(gate, fine) ** 2, pg, rnd, 0.0)
    return tf, num, fit, Hd


def icp_align(src, src_mask, tgt, tgt_mask, tgt_normals, init_guess, gate_multiplier, pg, rnd=geom.exact,
              min_correspondences: int = 10, fitness_threshold: float = 0.25) -> dict:
    """B pairs: src (B, Ps, 2) onto tgt (B, Pt, 2) from init_guess (B, 3).
    Returns transform (B, 3), converged (B,), num_corr, fitness, overlap
    and covariance (B, 3, 3), in chunks of pairs."""
    if not pg.icp_point_to_line or pg.icp_use_ransac_rejection:
        raise ValueError("the reference implements point-to-line ICP without RANSAC")
    if not pg.use_fixed_icp_covariance and pg.icp_covariance_mode != "gn":
        raise ValueError("the reference implements the fixed and the Gauss-Newton covariance")
    B, Ps = src_mask.shape
    chunk = max(1, _CHUNK_ELEMS // max(1, Ps * tgt_mask.shape[1]))
    args = [rnd(x) for x in (src, tgt, tgt_normals, init_guess)]
    outs = [_align(args[0][i:i + chunk], src_mask[i:i + chunk], args[1][i:i + chunk], tgt_mask[i:i + chunk],
                   args[2][i:i + chunk], args[3][i:i + chunk], gate_multiplier[i:i + chunk], pg, rnd)
            for i in range(0, B, chunk)]
    if not outs:
        z = init_guess.new_zeros
        outs = [(z((0, 3)), torch.zeros((0,), dtype=torch.int32, device=init_guess.device), z((0,)), z((0, 3, 3)))]
    tf, num, fit, Hd = (torch.cat(x) for x in zip(*outs))
    overlap = num.float() / torch.clamp(src_mask.sum(-1).float(), min=1.0)
    dev_xy = torch.linalg.norm(tf[:, :2] - init_guess[:, :2], dim=-1)
    converged = ((num >= min_correspondences) & (fit <= fitness_threshold) & (overlap >= pg.icp_min_overlap)
                 & (dev_xy <= gate_multiplier * pg.icp_max_correspondence_distance))
    fallback = torch.diag(torch.tensor([pg.laser_x_variance, pg.laser_y_variance, pg.laser_theta_variance],
                                       device=tf.device))
    if pg.use_fixed_icp_covariance:
        cov = fallback.expand(B, 3, 3)
    else:
        eye = torch.eye(3, device=tf.device)
        cov = 2.0 * pg.icp_sensor_noise_std ** 2 * geom.inv3(torch.where(converged[:, None, None], Hd, eye))
        floor = torch.tensor([pg.icp_cov_floor_transl ** 2] * 2 + [pg.icp_cov_floor_rot ** 2], device=tf.device)
        cov = torch.where(converged[:, None, None], cov + torch.diag(floor), fallback)
    return dict(transform=tf, converged=converged, num_corr=num, fitness=fit, overlap=overlap, covariance=cov)
