"""Plain DPG change detection (executeDPG of the reference DPG-SLAM): one
step on every lane of a stacked state, written as dense tensor work.

Per lane: the current pose chain (the last C keyframes of this pass), a
window at its centroid, the submap (the M nearest active prior-pass
nodes within the proximity radius of a chain node), a local
re-registration of each chain scan onto the submap's occupied points
(reference ICP, 12 iterations, kept within 6 cells), ADDED candidates
(chain points that at least min_free_views contributors saw through, off
submap structure and its margin), REMOVED candidates (submap points in a
chain node's free space, off chain structure, its margin and persistent
structure), the angular-bin commit gate per chain node, the label
commits, the sector punch-through and node deactivation. FREE is the
polar beam test at cell centres; OCCUPIED endpoint grids; dilation by a
(2m + 1) box. The deviations the program documents from the C++
reference (NOT_YET_LABELED as STATIC, M nearest contributors, a real bin
ratio, REMOVED labels on the owning node) are kept, since they define
the program's results.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slambench.reference import geom, icp, with_fields
from slambench.reference.frontend import ADDED, MAX_RANGE, NOT_YET_LABELED, REMOVED, STATIC, laser_points, normals

UNKNOWN, OCCUPIED = 0, 2
PUNCH_MAX_POINTS = 1024


def _div(x, c):
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def _cells(pts, origin, res):
    return torch.round(_div(pts, res)).to(torch.int32) - torch.round(_div(origin, res)).to(torch.int32)


def _inw(c, ext):
    return (c[..., 0] >= 0) & (c[..., 0] < ext) & (c[..., 1] >= 0) & (c[..., 1] < ext)


def _endpoint_grid(pts, occ, origin, ext, res):
    """(L, G, Q, 2) points, (L, G, Q) mask, (L, 2) origins -> (L, G, ext, ext) bool."""
    L, G = occ.shape[:2]
    c = _cells(pts, origin[:, None, None, :], res)
    ok = occ & _inw(c, ext)
    grid = torch.zeros((L, G, ext * ext + 1), dtype=torch.bool, device=pts.device)
    flat = torch.where(ok, c[..., 0].long() * ext + c[..., 1].long(), ext * ext)
    grid.scatter_(2, flat, True)
    return grid[..., :-1].reshape(L, G, ext, ext)


def _dilate(occ, m):
    if m <= 0:
        return occ
    shape = occ.shape
    x = occ.reshape(-1, 1, *shape[-2:]).float()
    x = F.max_pool2d(x, (2 * m + 1, 2 * m + 1), stride=1, padding=m)
    return (x > 0.5).reshape(shape)


def _lidar(cfg, poses):
    pg = cfg.pose_graph
    lp = torch.tensor([pg.laser_x_in_bl_frame, pg.laser_y_in_bl_frame, pg.laser_orientation_rel_bl_frame],
                      device=poses.device)
    return geom.compose(poses, lp.expand(poses.shape))


def _sector_ids(cfg, dev):
    i = torch.arange(cfg.scan.num_beams, dtype=torch.float32, device=dev)
    return torch.clamp(torch.floor(i / (cfg.scan.num_beams / cfg.dpg.num_sectors)), max=cfg.dpg.num_sectors - 1).long()


def _beam_select(cfg, labels, sector_active):
    on = sector_active[..., _sector_ids(cfg, labels.device)]
    ok = ((labels == MAX_RANGE) | (labels == STATIC) | (labels == NOT_YET_LABELED) | (labels == ADDED)
          | (labels == REMOVED))
    incl = on & ok
    return incl, incl & (labels != MAX_RANGE)


def _free_at(cfg, lidar, ranges, beam_mask, pts, slack):
    """(L, G, 3) scans, (L, Q, 2) points -> (L, G, Q): the point's cell
    centre lies in scan g's marched free space."""
    res = cfg.dpg.occ_grid_resolution
    sc = cfg.scan
    inc = (sc.angle_max - sc.angle_min) / (sc.num_beams - 1.0)
    pts = torch.round(_div(pts, res)) * res
    rel = geom.inv_apply(lidar, pts[:, None].expand(-1, lidar.shape[1], -1, -1))
    r = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    b = torch.round(_div(ang - sc.angle_min, inc)).to(torch.int32)
    infov = (b >= 0) & (b <= sc.num_beams - 1)
    bc = torch.clamp(b, 0, sc.num_beams - 1).long()
    rg, mk = torch.gather(ranges, -1, bc), torch.gather(beam_mask, -1, bc)
    cross = (ang - (sc.angle_min + bc.float() * inc)).abs() * r <= 0.5 * res + 1e-6
    return infov & mk & cross & (r <= rg - slack)


def _rows(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def execute(cfg, st: dict, rnd=geom.exact) -> dict:
    """One DPG step on every lane. st holds (L, ...) poses, pass_ids,
    node_active, ranges, labels, sector_active, cloud, cloud_mask,
    num_nodes, pass_number. Returns labels, sector_active, node_active."""
    d = cfg.dpg
    C, M, ext, res = d.current_pose_chain_len, d.max_submap_nodes, d.grid_extent_cells, d.occ_grid_resolution
    B, NS = cfg.scan.num_beams, d.num_sectors
    if d.submap_coverage_growth or d.replicate_int_bin_ratio:
        raise ValueError("the reference implements the M-nearest submap and the real bin ratio")
    poses, ranges = rnd(st["poses"]), rnd(st["ranges"])
    L, N = poses.shape[:2]
    dev = poses.device
    lane = torch.arange(L, device=dev)
    idx = torch.arange(N, device=dev)
    node_mask = idx < st["num_nodes"][:, None]
    pass_no = st["pass_number"][:, None]

    cidx = st["num_nodes"][:, None].long() - 1 - torch.arange(C, device=dev)
    cvalid = (cidx >= 0) & (_rows(st["pass_ids"], torch.clamp(cidx, min=0)) == pass_no)
    cidx = torch.clamp(cidx, min=0)
    cposes = _rows(poses, cidx)
    cranges = _rows(ranges, cidx)
    cent = torch.where(cvalid[..., None], cposes[..., :2], 0.0).sum(1) / torch.clamp(cvalid.sum(1), min=1)[:, None]
    origin = cent - 0.5 * ext * res
    pl = rnd(laser_points(cranges, cfg.scan))
    cincl, cocc = _beam_select(cfg, _rows(st["labels"], cidx), _rows(st["sector_active"], cidx))
    cincl, cocc = cincl & cvalid[..., None], cocc & cvalid[..., None]

    prior = node_mask & (st["pass_ids"] != pass_no) & st["node_active"]
    dch = torch.linalg.norm(poses[:, :, None, :2] - cposes[:, None, :, :2], dim=-1)
    dmin = torch.where(cvalid[:, None, :], dch, float("inf")).amin(2)
    cok = prior & (dmin <= d.distance_threshold_for_local_submap_nodes)
    sidx = torch.argsort(torch.where(cok, dmin, float("inf")), dim=-1, stable=True)[:, :M]
    svalid = torch.gather(cok, 1, sidx)
    slidar = _lidar(cfg, _rows(poses, sidx))
    sranges = _rows(ranges, sidx)
    spts = geom.apply(slidar, rnd(laser_points(sranges, cfg.scan)))
    sincl, socc = _beam_select(cfg, _rows(st["labels"], sidx), _rows(st["sector_active"], sidx))
    sincl, socc = sincl & svalid[..., None], socc & svalid[..., None]
    sflat = spts.reshape(L, M * B, 2)

    if d.local_registration:
        pg = with_fields(cfg.pose_graph, icp_maximum_iterations=min(12, cfg.pose_graph.icp_maximum_iterations))
        T = d.local_reg_max_points
        stride = max(1, (M * B) // T)
        tp, tok = sflat[:, ::stride][:, :T], socc.reshape(L, M * B)[:, ::stride][:, :T]
        if tp.shape[1] < T:
            tp = torch.cat([tp, tp.new_zeros((L, T - tp.shape[1], 2))], 1)
            tok = torch.cat([tok, tok.new_zeros((L, T - tok.shape[1]))], 1)
        src = _rows(rnd(st["cloud"]), cidx).reshape(L * C, -1, 2)
        smask = (_rows(st["cloud_mask"], cidx) & cvalid[..., None]).reshape(L * C, -1)
        tgt = tp[:, None].expand(L, C, T, 2).reshape(L * C, T, 2)
        tmask = tok[:, None].expand(L, C, T).reshape(L * C, T)
        reg = icp.icp_align(src, smask, tgt, tmask, normals(tgt, tmask), cposes.reshape(L * C, 3),
                            torch.ones((L * C,), device=dev), pg, rnd)
        tf = reg["transform"].view(L, C, 3)
        ok = reg["converged"].view(L, C) & (torch.linalg.norm(tf[..., :2] - cposes[..., :2], dim=-1) <= 6.0 * res)
        cposes = torch.where(ok[..., None], tf, cposes)
    clidar = _lidar(cfg, cposes)
    cpts = geom.apply(clidar, pl)

    chain_occ_grids = _endpoint_grid(cpts, cocc, origin, ext, res)
    sub_occ_grid = _endpoint_grid(sflat[:, None], socc.reshape(L, 1, M * B), origin, ext, res)[:, 0]

    cflat = cpts.reshape(L, C * B, 2)
    ccells = _cells(cpts, origin[:, None, None, :], res)
    cinw = _inw(ccells, ext)
    ccx, ccy = torch.clamp(ccells[..., 0], 0, ext - 1).long(), torch.clamp(ccells[..., 1], 0, ext - 1).long()
    l3 = lane.view(L, 1, 1)
    votes = _free_at(cfg, slidar, sranges, sincl, cflat, res).sum(1).reshape(L, C, B)
    sub_near = _dilate(sub_occ_grid, d.change_margin_cells)
    added = (cocc & cinw & (votes >= max(d.min_free_views, 1)) & ~sub_occ_grid[l3, ccx, ccy] & ~sub_near[l3, ccx, ccy])

    scells = _cells(spts, origin[:, None, None, :], res)
    sinw = _inw(scells, ext)
    scx, scy = torch.clamp(scells[..., 0], 0, ext - 1).long(), torch.clamp(scells[..., 1], 0, ext - 1).long()
    cfree = _free_at(cfg, clidar, cranges, cincl, sflat, res).reshape(L, C, M, B)
    at = (lane.view(L, 1, 1, 1), torch.arange(C, device=dev).view(1, C, 1, 1), scx[:, None], scy[:, None])
    near_any = _dilate(chain_occ_grids, d.change_margin_cells)[at].any(1)
    removed = (socc & sinw)[:, None] & cfree & ~chain_occ_grids[at] & ~near_any[:, None]

    cand_any = removed.any(1) & sinw
    cand = torch.zeros((L, ext * ext + 1), dtype=torch.bool, device=dev)
    cand.scatter_(1, torch.where(cand_any, scx * ext + scy, ext * ext).reshape(L, -1), True)
    persistent = sub_occ_grid & ~cand[:, :-1].reshape(L, ext, ext)
    removed = removed & ~_dilate(persistent, d.change_margin_cells)[l3, scx, scy][:, None]

    nb = d.num_bins_for_change_detection
    amin, amax = cfg.scan.angle_min, cfg.scan.angle_max
    allp = torch.cat([cpts, sflat[:, None].expand(L, C, -1, -1)], 2)
    allv = torch.cat([added, removed.reshape(L, C, M * B)], 2)
    rel = geom.inv_apply(clidar, allp)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    okb = allv & (ang >= amin) & (ang <= amax)
    b = torch.clamp(_div(ang - amin, (amax - amin) / nb).to(torch.int32), 0, nb - 1)
    hist = torch.zeros((L, C, nb + 1), dtype=torch.bool, device=dev)
    hist.scatter_(2, torch.where(okb, b, nb).long(), True)
    counts = hist[..., :nb].sum(-1)
    has = added.any(-1) | removed.reshape(L, C, -1).any(-1)
    commit = cvalid & has & ((_div(counts.float(), float(nb)) >= d.delta_change_threshold)
                             | (counts >= d.min_changed_bins_for_commit))

    add_c = added & commit[..., None]
    rem_c = (removed & commit[..., None, None]).any(1)
    labels = torch.cat([st["labels"], st["labels"].new_zeros((L, 1, B))], 1).clone()
    beam = torch.arange(B, device=dev)
    rows = torch.where(add_c, cidx[..., None], N)
    labels[l3.expand_as(rows), rows, beam.expand_as(rows)] = ADDED
    srows = torch.where(rem_c, sidx[..., None], N)
    labels[l3.expand_as(srows), srows, beam.expand_as(srows)] = REMOVED
    sec = _sector_ids(cfg, dev)
    sact = torch.cat([st["sector_active"], st["sector_active"].new_zeros((L, 1, NS))], 1).clone()
    sact[l3.expand_as(srows), srows, sec.expand_as(srows)] = False

    rv = rem_c.reshape(L, M * B)
    top = torch.argsort((~rv).to(torch.int8), dim=-1, stable=True)[:, :min(PUNCH_MAX_POINTS, M * B)]
    rpts = torch.gather(sflat, 1, top[..., None].expand(-1, -1, 2))
    rval = torch.gather(rv, 1, top)
    past = node_mask & (st["pass_ids"] != pass_no)
    rel = geom.inv_apply(_lidar(cfg, poses), rpts[:, None].expand(L, N, -1, 2))
    rr = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    infov = rval[:, None] & past[..., None] & (rr <= cfg.scan.range_max) & (ang >= amin) & (ang <= amax)
    psec = torch.clamp(_div(ang - amin, (amax - amin) / NS).to(torch.int32), 0, NS - 1).long()
    approx = _div(ang - amin, cfg.scan.angle_increment)
    i0 = torch.clamp(torch.floor(approx).to(torch.int32), 0, B - 1).long()
    i1 = torch.clamp(i0 + 1, max=B - 1)
    fov = torch.minimum(torch.gather(ranges, 2, i0), torch.gather(ranges, 2, i1))
    punch = infov & (fov > rr + 2.0 * res)
    prow = torch.where(punch, idx[:, None], N)
    sact[lane.view(L, 1, 1).expand_as(prow), prow, psec] = False
    labels, sact = labels[:, :N], sact[:, :N]
    frac = sact.float().mean(-1)
    node_active = st["node_active"] & torch.where(past, frac >= d.minimum_percent_active_sectors, True)
    return dict(labels=labels, sector_active=sact, node_active=node_active)
