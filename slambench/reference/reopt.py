"""Plain pass boundary (reoptimize, dpg_slam.cc:35-120, then the pass
handshake of dpg_data_runner_main.cc:30-52) of every lane: the full pair
set (each node's successive pair and its K nearest loop-closure
candidates), every live pair registered by the reference ICP from the
current poses, the factor graph rebuilt (a prior at each pass's first
node, odometry factors from the odometry log, successive factors always,
converged closures that win the consistency vote), then a cold LM solve
on the node bucket."""

from __future__ import annotations

import torch

from slambench.reference import geom, icp, lm


def node_bucket(n: int, cap: int) -> int:
    b = 64
    while b < n:
        b *= 2
    return min(b, cap)


def motion_sigmas(pg, displ):
    d = torch.linalg.norm(displ[..., :2], dim=-1)
    a = displ[..., 2].abs()
    tr = pg.motion_model_transl_error_from_transl * d + pg.motion_model_transl_error_from_rot * a
    rot = pg.motion_model_rot_error_from_transl * d + pg.motion_model_rot_error_from_rot * a
    return torch.clamp(torch.stack([tr, tr, rot], -1), min=1e-3)


def sqrt_info_from_cov(cov):
    """R = L^-1 with R^T R = cov^-1."""
    L = torch.linalg.cholesky(cov.double())
    return torch.linalg.inv(L).float()


def consistency_votes(pg, poses_tgt, transforms, ref_pose, valid):
    corr = geom.compose(poses_tgt, transforms) - ref_pose[..., None, :]
    corr = torch.cat([corr[..., :2], geom.wrap(corr[..., 2:3])], -1)
    dt = torch.linalg.norm(corr[..., :, None, :2] - corr[..., None, :, :2], dim=-1)
    dr = geom.wrap(corr[..., :, None, 2] - corr[..., None, :, 2]).abs()
    agree = (dt <= pg.closure_consistency_transl) & (dr <= pg.closure_consistency_rot) & valid[..., :, None] & valid[..., None, :]
    votes = agree.sum(-1)
    return valid & (votes >= torch.where(valid, votes, 0).amax(-1, keepdim=True))


def _lane_graph(cfg, st, s, nb, rnd):
    """Lane s's pair set, sweep and rebuilt graph on the bucket [:nb]."""
    pg = cfg.pose_graph
    K = pg.max_loop_closures_per_node
    dev = st["poses"].device
    n = int(st["num_nodes"][s])
    poses = st["poses"][s, :nb]
    pass_ids = st["pass_ids"][s, :nb]
    idx = torch.arange(nb, device=dev)
    live = idx < n
    dist = torch.linalg.norm(poses[:, None, :2] - poses[None, :, :2], dim=-1)
    same = pass_ids[:, None] == pass_ids[None, :]
    thr = torch.where(same, pg.maximum_node_dist_within_pass_scan_comparison,
                      pg.maximum_node_dist_across_passes_scan_comparison)
    gap = ~same | ((idx[:, None] - idx[None, :]) >= pg.min_loop_closure_node_gap)
    cand = live[:, None] & live[None, :] & (idx[None, :] < idx[:, None] - 1) & (dist <= thr) & gap
    cidx = torch.argsort(torch.where(cand, dist, float("inf")), dim=-1, stable=True)[:, :K]
    cval = torch.gather(cand, 1, cidx)
    tgt = torch.cat([torch.clamp(idx - 1, min=0)[:, None], cidx], 1)       # (nb, 1 + K)
    val = torch.cat([(live & (idx > 0))[:, None], cval], 1)
    src = idx[:, None].expand_as(tgt)
    seeds = geom.between(poses[tgt], poses[src])
    gate = torch.full(tgt.shape, pg.reoptimize_gate_multiplier, device=dev)
    gate[:, 0] = 1.0
    v = val.reshape(-1)
    fs, ft = src.reshape(-1)[v], tgt.reshape(-1)[v]
    cloud, cmask, cnrm = rnd(st["cloud"][s]), st["cloud_mask"][s], rnd(st["cloud_normals"][s])
    res = icp.icp_align(cloud[fs], cmask[fs], cloud[ft], cmask[ft], cnrm[ft], seeds.reshape(-1, 3)[v],
                        gate.reshape(-1)[v], pg, rnd)
    tf = seeds.reshape(-1, 3).clone()
    tf[v] = res["transform"]
    conv = torch.zeros(v.shape, dtype=torch.bool, device=dev)
    conv[v] = res["converged"]
    cov = torch.diag(torch.tensor([pg.laser_x_variance, pg.laser_y_variance, pg.laser_theta_variance],
                                  device=dev)).expand(v.shape[0], 3, 3).clone()
    cov[v] = res["covariance"]

    prev_pass = torch.cat([torch.full((1,), -1, dtype=pass_ids.dtype, device=dev), pass_ids[:-1]])
    first = live & (pass_ids != prev_pass)
    odom = st["odom_poses"][s, :nb]
    odispl = geom.between(torch.roll(odom, 1, dims=0), odom)
    odo_valid = live & (idx > 0) & ~first & pg.odometry_constraints
    keep_cl = conv.reshape(nb, 1 + K)
    if pg.closure_consistency_transl is not None:
        voted = consistency_votes(pg, poses[tgt[:, 1:]], tf.reshape(nb, 1 + K, 3)[:, 1:], poses,
                                  (val & keep_cl)[:, 1:])
        keep_cl = torch.cat([keep_cl[:, :1], voted], 1)
    keep = (val & (torch.arange(1 + K, device=dev) == 0)) | (val & keep_cl)
    keep = keep.reshape(-1)
    E, P = cfg.capacity.max_edges, cfg.capacity.max_priors
    pairs = torch.cat([torch.stack([torch.clamp(idx - 1, min=0), idx], 1)[odo_valid],
                       torch.stack([tgt.reshape(-1), src.reshape(-1)], 1)[keep]])
    meas = torch.cat([odispl[odo_valid], tf[keep]])
    si = torch.cat([torch.diag_embed(1.0 / motion_sigmas(pg, odispl[odo_valid])), sqrt_info_from_cov(cov[keep])])
    if pairs.shape[0] > E:
        raise ValueError(f"lane {s}: {pairs.shape[0]} factors exceed the edge capacity {E}")
    g = dict(
        prior_idx=torch.zeros((P,), dtype=torch.int32, device=dev),
        prior_val=torch.zeros((P, 3), device=dev),
        prior_sqrt_info=torch.diag(1.0 / torch.tensor([pg.new_pass_x_std_dev, pg.new_pass_y_std_dev,
                                                       pg.new_pass_theta_std_dev], device=dev)).expand(P, 3, 3).clone(),
        num_priors=first.sum().to(torch.int32),
        edge_idx=torch.zeros((E, 2), dtype=torch.int32, device=dev),
        edge_meas=torch.zeros((E, 3), device=dev),
        edge_sqrt_info=torch.zeros((E, 3, 3), device=dev),
        num_edges=torch.tensor(pairs.shape[0], dtype=torch.int32, device=dev),
    )
    fi = idx[first]
    g["prior_idx"][:fi.shape[0]] = fi.to(torch.int32)
    g["edge_idx"][:pairs.shape[0]] = pairs.to(torch.int32)
    g["edge_meas"][:pairs.shape[0]] = meas
    g["edge_sqrt_info"][:pairs.shape[0]] = si
    return g


def increment_pass(cfg, st: dict, rnd=geom.exact):
    """Every lane's re-aligned poses (S, N, 3) after the pass boundary, and
    the rebuilt graphs (a dict of (S, ...) tensors)."""
    pg = cfg.pose_graph
    S, N = st["poses"].shape[:2]
    nb = node_bucket(int(st["num_nodes"].max()), cfg.capacity.max_nodes)
    graphs = [_lane_graph(cfg, st, s, nb, rnd) for s in range(S)]
    g = {k: torch.stack([x[k] for x in graphs]) for k in graphs[0]}
    node_mask = torch.arange(nb, device=st["poses"].device) < st["num_nodes"][:, None]
    out = lm.solve(rnd(st["poses"][:, :nb]), g, node_mask, method="lanes",
                   max_iterations=min(pg.gn_max_iterations, pg.gtsam_max_iterations), damping_init=pg.gn_damping_init,
                   robust_delta=pg.robust_delta, rel_tol=pg.gn_tol, rnd=rnd)
    return torch.cat([out, st["poses"][:, nb:]], 1), g
