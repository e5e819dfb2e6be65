"""Plain keyframe frontend of every lane (createNode and
_icp_pairs_for_new_node / _keyframe_frontend_post, dpg_slam.cc:488-513,
264-267): from the poses and pass ids the step starts from, and the new
node's pose and pass, the successive pair and the K nearest loop-closure
candidates, every pair registered by the reference ICP on the reference's
own node clouds, the closure consistency vote, and the factor rows the
step appends (an odometry factor unless the node starts a pass, the
successive factor always, converged closures that win the vote)."""

from __future__ import annotations

import torch

from slambench.reference import geom, icp, reopt


def step(cfg, entry: dict, nodes: dict, first: torch.Tensor, rnd=geom.exact) -> dict:
    """entry: the step's starting poses (S, N, 3), pass_ids (S, N),
    num_nodes (S,), valid (S,), and the new node's est_pose (S, 3) and
    pass_no (S,); nodes: the reference's node clouds (S, Nr, P, 2) with
    their masks and normals; first (S,): the new node starts a pass.
    Returns tgt_idx and tgt_valid (S, 1 + K) of the pairs, their
    transform, converged and sqrt_info, keep (S, 1 + K) the pairs that
    become factors, and odo (S,) the odometry factor."""
    pg = cfg.pose_graph
    K = pg.max_loop_closures_per_node
    poses, valid, est = entry["poses"], entry["valid"], entry["est_pose"]
    S, N = poses.shape[:2]
    dev = poses.device
    lane = torch.arange(S, device=dev)
    new = entry["num_nodes"].long()
    prec = new - 1
    idx = torch.arange(N, device=dev)
    dist = torch.linalg.norm(poses[..., :2] - est[:, None, :2], dim=-1)
    same = entry["pass_ids"] == entry["pass_no"][:, None]
    thr = torch.where(same, pg.maximum_node_dist_within_pass_scan_comparison,
                      pg.maximum_node_dist_across_passes_scan_comparison)
    ok = (idx < prec[:, None]) & (dist <= thr) & (~same | (new[:, None] - idx >= pg.min_loop_closure_node_gap))
    cand = torch.argsort(torch.where(ok, dist, float("inf")), dim=-1, stable=True)[:, :K]
    tgt = torch.cat([torch.clamp(prec, min=0)[:, None], cand], 1)
    tv = torch.cat([(new > 0)[:, None], torch.gather(ok, 1, cand)], 1) & valid[:, None]

    cloud, cmask, cnrm = nodes["cloud"], nodes["cloud_mask"], nodes["cloud_normals"]
    Nr = cloud.shape[1]
    src_i, tgt_i = torch.clamp(new, max=Nr - 1), torch.clamp(tgt, max=Nr - 1)
    at = (lane[:, None], tgt_i)
    src = cloud[lane, src_i][:, None].expand(S, K + 1, -1, -1)
    smask = (cmask[lane, src_i] & valid[:, None])[:, None].expand(S, K + 1, -1)
    tmask = cmask[at] & tv[..., None]
    init = geom.between(poses[lane[:, None], tgt], est[:, None].expand(S, K + 1, 3))
    succ = torch.arange(K + 1, device=dev) == 0
    gate = torch.where(succ, 1.0, pg.icp_coarse_gate_multiplier).expand(S, K + 1)

    def flat(x):
        return x.reshape((S * (K + 1),) + x.shape[2:])

    res = icp.icp_align(flat(src), flat(smask), flat(cloud[at]), flat(tmask), flat(cnrm[at]), flat(init), flat(gate),
                        pg, rnd)
    tf = res["transform"].view(S, K + 1, 3)
    conv = res["converged"].view(S, K + 1)
    keep = tv if pg.non_successive_scan_constraints else tv & succ
    if pg.closure_consistency_transl is not None:
        voted = reopt.consistency_votes(pg, poses[lane[:, None], cand], tf[:, 1:], est, keep[:, 1:] & conv[:, 1:])
        keep = torch.cat([keep[:, :1], voted], 1)
    keep = keep & (conv | succ)
    si = reopt.sqrt_info_from_cov(rnd(res["covariance"])).view(S, K + 1, 3, 3)
    odo = ~first & bool(pg.odometry_constraints) & valid
    return dict(tgt_idx=tgt, tgt_valid=tv, transform=tf, converged=conv, sqrt_info=si, keep=keep, odo=odo)
