"""The comparison that decides a run's ``correct``: what the timed path
produced, against the plain reference on the same inputs.

The program's outputs are the final states of the window's jobs and the
stage results ``capture.Capture`` copied during one of them. The
reference recomputes each from the benchmark's own inputs (the scans and
odometry it generated) or, where it can only follow the program step by
step, from the program's state at the stage's entry:

  nodes_gap      the start: every stored node's scan, downsampled cloud
                 and normals against the reference's from the scan that
                 lane's keyframe schedule picks (largest |gap|), plus 1 for
                 each node a job holds too many or too few (the worst job)
                 and for each cloud mask that differs
  k1_gap         the keyframe step's registrations (K1 on the card) and the
                 measurements of the factor rows it appends, against the
                 reference frontend (reference/keyframe.py: its own
                 candidates, ICP and vote from the step's starting poses):
                 largest |gap| of a transform component (headings
                 wrapped) over the pairs both pick and either accepts
  edge_misses    the factor rows the keyframe step appends against the
                 reference's: rows (node pairs) in one set and not in the
                 other, plus successive factors whose registration one
                 side accepts and the other does not (their information
                 differs); a dropped, added or wrongly voted closure
                 counts here
  info_gap       the square-root information of every factor row both
                 append from a registration both accept, against the
                 reference's from its ICP covariance: largest |gap| over
                 the largest |entry| of the reference's row
  solve_gap      the lane solve's poses against the reference LM from the
                 same poses and graph, as the relative pose of every live
                 edge: each lane's largest |gap|, the median over the
                 lanes of the copied solves (a lane's own largest gap is
                 chaotic in float32: PERF.md, the check)
  solve_lanes_off  the share of the copied solves' lanes whose largest
                 gap exceeds LANE_OFF_M (1 cm): a fault on a part of the
                 lanes, which the median does not see
  dpg_mismatch   a DPG step's labels, sector and node activity against the
                 reference step on the same state (entries that differ)
  boundary_gap   the pass boundary's re-aligned poses against the
                 reference's sweep, rebuilt graph and cold LM from the same
                 pass-0 state, as the relative pose of every edge of the
                 reference's graph: each lane's largest |gap|, the median
                 lane (the cold LM ends where rounding leads it on a lane
                 now and then: PERF.md, the check)
  boundary_lanes_off  the share of the boundary's lanes whose largest gap
                 exceeds LANE_OFF_M (1 mm)

``outputs(..., rnd=geom.tf32)`` is the control: the reference in the
program's place, computed in TF32 (its keyframe steps' rows are the rows
its own decisions make).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from slambench.reference import dpg as ref_dpg
from slambench.reference import frontend as ref_front
from slambench.reference import geom, keyframe as ref_kf, lm as ref_lm, reopt as ref_reopt


# The numbers each stage gives (nodes_gap is every cell's).
NUMBERS = {"frontend": ("k1_gap", "edge_misses", "info_gap"), "solve": ("solve_gap", "solve_lanes_off"),
           "dpg": ("dpg_mismatch",), "boundary": ("boundary_gap", "boundary_lanes_off")}


# A lane of a solve or a pass boundary is off where its largest
# edge-relative gap exceeds this (m): above what sound runs read on all but
# a lane in a few hundred, below what the control and the faults read on
# most lanes (PERF.md, the check).
LANE_OFF_M = {"solve": 0.01, "boundary": 0.001}


def number_names(stages) -> set:
    return {"nodes_gap"} | {n for s in stages for n in NUMBERS[s]}


def expected_counts(cfg, lane_passes) -> np.ndarray:
    """(S,) keyframes each lane should hold: per pass the keyframe
    schedule of its odometry, capped (frontend.keyframe_cap)."""
    cap = ref_front.keyframe_cap(cfg)
    return np.array([sum(min(int(ref_front.keyframe_schedule(cfg.pose_graph, odo).sum()), cap) for odo, _ in passes)
                     for passes in lane_passes])


def pass_starts(cfg, lane_passes) -> list:
    """Per lane, the node indices that start a pass."""
    cap = ref_front.keyframe_cap(cfg)
    out = []
    for passes in lane_passes:
        counts = [min(int(ref_front.keyframe_schedule(cfg.pose_graph, odo).sum()), cap) for odo, _ in passes]
        out.append(set(np.cumsum([0] + counts[:-1]).tolist()))
    return out


def keyframe_scans(cfg, lane_passes, device):
    """(S, N, B) the scans the schedule makes nodes of, and (S, N) live."""
    cap = ref_front.keyframe_cap(cfg)
    rows = [np.concatenate([scans[ref_front.keyframe_schedule(cfg.pose_graph, odo)][:cap] for odo, scans in passes])
            for passes in lane_passes]
    N = max(len(r) for r in rows)
    out = np.zeros((len(rows), N, cfg.scan.num_beams), np.float32)
    live = np.zeros((len(rows), N), bool)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
        live[s, :len(r)] = True
    return torch.as_tensor(out, device=device), torch.as_tensor(live, device=device)


def _solve(cfg, item, rnd):
    kw = item["inp"]["kw"]
    method = {"chol": "chol", "cg_fixed": "cg"}[kw["method"]]
    return ref_lm.solve(item["inp"]["poses"], item["inp"]["graph"], item["inp"]["node_mask"], method=method,
                        max_iterations=kw["max_iterations"], damping_init=kw["damping_init"],
                        robust_delta=kw["robust_delta"], gradient_tol=kw["gradient_tol"],
                        terminate_on_reject=kw["terminate_on_reject"], rel_tol=kw["rel_tol"],
                        cg_iterations=kw["cg_iterations"], rnd=rnd)


def outputs(cfg, lane_passes, items, rnd, device) -> dict:
    """The reference's outputs (rnd=geom.exact) or the control's
    (rnd=geom.tf32), in the layout of program_outputs."""
    scans, live = keyframe_scans(cfg, lane_passes, device)
    _, cloud, mask, nrm = ref_front.prepare_cloud(cfg, rnd(scans))
    rounded = [[(rnd(torch.as_tensor(o)).numpy(), s) for o, s in passes] for passes in lane_passes]
    out = dict(keyframes=[expected_counts(cfg, rounded)],
               nodes=dict(ranges=rnd(scans), cloud=cloud, cloud_mask=mask, cloud_normals=nrm, live=live))
    starts = pass_starts(cfg, rounded)
    out["frontend"] = []
    for it in items["frontend"]:
        first = torch.tensor([int(n) in st for n, st in zip(it["num_nodes"].tolist(), starts)], device=device)
        kf = ref_kf.step(cfg, it, out["nodes"], first, rnd)
        out["frontend"].append(dict(call=it["call"], new=it["num_nodes"], **kf, rows=_rows(kf, it["num_nodes"])))
    out["solve"] = [dict(call=it["call"], poses=_solve(cfg, it, rnd), graph=it["inp"]["graph"])
                    for it in items["solve"]]
    out["dpg"] = []
    for it in items["dpg"]:
        live_n = torch.arange(it["inp"]["poses"].shape[1], device=device) < it["inp"]["num_nodes"][:, None]
        out["dpg"].append(dict(call=it["call"], live=live_n, **ref_dpg.execute(cfg, it["inp"], rnd)))
    out["boundary"] = []
    for it in items["boundary"]:
        poses, graph = ref_reopt.increment_pass(cfg, it["inp"], rnd)
        out["boundary"].append(dict(call=it["call"], poses=poses, graph=graph))
    return out


def _rows(kf: dict, num_nodes) -> dict:
    """The factor rows a keyframe step of the reference (or the control)
    appends, laid out as the program's captured rows: pair, measurement,
    square-root information and count per lane, odometry row first (its
    measurement and information are not compared)."""
    S, K1 = kf["keep"].shape
    dev = kf["keep"].device
    new = num_nodes.long()
    pair = torch.stack([torch.cat([torch.clamp(new - 1, min=0)[:, None], kf["tgt_idx"]], 1),
                        new[:, None].expand(S, K1 + 1)], -1)
    keep = torch.cat([kf["odo"][:, None], kf["keep"]], 1)
    meas = torch.cat([torch.zeros((S, 1, 3), device=dev), kf["transform"]], 1)
    si = torch.cat([torch.zeros((S, 1, 3, 3), device=dev), kf["sqrt_info"]], 1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    take = lambda x: torch.gather(x, 1, order.view(order.shape + (1,) * (x.ndim - 2)).expand_as(x))  # noqa: E731
    return dict(idx=take(pair), meas=take(meas), sqrt_info=take(si), n=keep.sum(1))


def program_outputs(items, job_nodes, final) -> dict:
    """The program's outputs: the node counts of every job, the final
    state of the capture job, and the captured stage results."""
    out = dict(keyframes=job_nodes, nodes=final)
    out["frontend"] = []
    for it in items["frontend"]:
        if "cand" not in it or "transform" not in it:
            continue  # the step picked no candidates or registered nothing: the stage reads inf
        tgt = torch.cat([torch.clamp(it["num_nodes"].long() - 1, min=0)[:, None], it["cand"].long()], 1)
        K1 = tgt.shape[1]
        out["frontend"].append(dict(call=it["call"], tgt_idx=tgt, transform=it["transform"].view(-1, K1, 3),
                                    converged=it["converged"].view(-1, K1), rows=it["rows"]))
    out["solve"] = [dict(call=it["call"], poses=it["poses"]) for it in items["solve"]]
    out["dpg"] = [dict(call=it["call"], **it["out"]) for it in items["dpg"]]
    out["boundary"] = [dict(call=it["call"], poses=it["poses"]) for it in items["boundary"]]
    return out


def _max_gap(a, b, mask=None) -> float:
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def _pose_gap(a, b, mask=None) -> float:
    """Largest |gap| of (..., 3) poses: x and y in m, the heading in rad
    wrapped (a heading of pi and one of -pi agree)."""
    d = (a.double() - b.double())
    d = torch.cat([d[..., :2], geom.wrap(d[..., 2:3])], dim=-1).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def _edge_gaps(a, b, graph) -> torch.Tensor:
    """(S,) per lane, the largest |gap| between the relative poses
    (between(x_i, x_j)) that two (S, N, 3) pose sets give its live edges:
    what the solve determines, free of the common drift of a whole lane,
    which the weak priors leave to rounding. 0 for a lane without edges."""
    S, E = graph["edge_idx"].shape[:2]
    em = torch.arange(E, device=a.device) < graph["num_edges"][:, None]
    ei = torch.where(em[..., None], graph["edge_idx"], 0).long()
    lane = torch.arange(S, device=a.device)[:, None]
    a, b = a.double(), b.double()
    d = geom.between(a[lane, ei[..., 0]], a[lane, ei[..., 1]]) - geom.between(b[lane, ei[..., 0]], b[lane, ei[..., 1]])
    d = torch.cat([d[..., :2], geom.wrap(d[..., 2:3])], dim=-1).abs().amax(-1)
    d = torch.where(torch.isnan(d), float("inf"), d)
    return torch.where(em, d, 0.0).amax(-1)


def _lane_numbers(lanes: list, off_m: float) -> tuple[float, float]:
    """The median lane's widest gap and the share of lanes whose widest
    gap exceeds off_m, over the (S,) gaps of the copied calls."""
    g = torch.cat(lanes) if lanes else torch.zeros(0)
    if not g.numel():
        return 0.0, 0.0
    return float(g.median()), float((g > off_m).double().mean())


def _frontend(prog: list, ref: list) -> tuple[float, int, float]:
    """(k1_gap, edge_misses, info_gap) of the copied keyframe steps."""
    k1, misses, info = 0.0, 0, 0.0
    for p, q in zip(prog, ref):
        same = (p["tgt_idx"] == q["tgt_idx"]) & q["tgt_valid"]
        k1 = max(k1, _pose_gap(p["transform"], q["transform"], same & (p["converged"] | q["converged"])))
        P = {k: v.cpu() for k, v in p["rows"].items()}
        Q = {k: v.cpu() for k, v in q["rows"].items()}
        same, keep, odo = same.cpu(), q["keep"].cpu(), q["odo"].cpu()
        cp, cq, tq, new = p["converged"].cpu(), q["converged"].cpu(), q["tgt_idx"].cpu(), q["new"].cpu()
        tf, si = q["transform"].cpu(), q["sqrt_info"].cpu()
        S, K1 = keep.shape
        for s in range(S):
            rp = [tuple(r) for r in P["idx"][s, :int(P["n"][s])].tolist()]
            rq = [tuple(r) for r in Q["idx"][s, :int(Q["n"][s])].tolist()]
            a, b = collections.Counter(rp), collections.Counter(rq)
            misses += sum((a - b).values()) + sum((b - a).values())
            for k in range(K1):
                if not (keep[s, k] and same[s, k]):
                    continue
                # The program's row of pair k: the successive pair shares its
                # nodes with the odometry row, which comes first.
                hits = [i for i, r in enumerate(rp) if r == (int(tq[s, k]), int(new[s]))]
                skip = int(k == 0 and bool(odo[s]))
                if len(hits) <= skip:
                    continue  # counted above
                i = hits[skip]
                if bool(cp[s, k]) != bool(cq[s, k]):
                    misses += 1
                    continue
                ref_si = si[s, k].double()
                info = max(info, float((P["sqrt_info"][s, i].double() - ref_si).abs().max() / ref_si.abs().max()))
                if cq[s, k]:
                    k1 = max(k1, _pose_gap(P["meas"][s, i], tf[s, k]))
    return k1, misses, info


def compare(cfg, prog: dict, ref: dict, stages, planned: dict) -> dict:
    """The numbers of `stages` for outputs `prog` against the reference's.
    A stage of which fewer calls were copied than `planned` (its entry was
    not called by the name the capture wraps) reads inf."""
    nums = {}
    want = ref["keyframes"][0]
    counts = max(float(np.abs(np.asarray(k) - want).sum()) for k in prog["keyframes"])
    n, r = prog["nodes"], ref["nodes"]
    Nr = r["live"].shape[1]
    live = r["live"]
    gap = max(_max_gap(n["ranges"][:, :Nr], r["ranges"], live), _max_gap(n["cloud"][:, :Nr], r["cloud"], live),
              _max_gap(n["cloud_normals"][:, :Nr], r["cloud_normals"], live))
    nums["nodes_gap"] = gap + counts + float((n["cloud_mask"][:, :Nr] != r["cloud_mask"])[live].any(-1).sum())
    nums["k1_gap"], misses, nums["info_gap"] = _frontend(prog["frontend"], ref["frontend"])
    nums["edge_misses"] = float(misses)
    if "solve" in stages:
        lanes = [_edge_gaps(p["poses"], q["poses"], q["graph"]) for p, q in zip(prog["solve"], ref["solve"])]
        nums["solve_gap"], nums["solve_lanes_off"] = _lane_numbers(lanes, LANE_OFF_M["solve"])
    if "dpg" in stages:
        nums["dpg_mismatch"] = float(sum(
            int((p["labels"] != q["labels"])[q["live"]].sum() + (p["sector_active"] != q["sector_active"])[q["live"]].sum()
                + (p["node_active"] != q["node_active"])[q["live"]].sum())
            for p, q in zip(prog["dpg"], ref["dpg"])))
    if "boundary" in stages:
        lanes = [_edge_gaps(p["poses"], q["poses"], q["graph"]) for p, q in zip(prog["boundary"], ref["boundary"])]
        nums["boundary_gap"], nums["boundary_lanes_off"] = _lane_numbers(lanes, LANE_OFF_M["boundary"])
    for stage, names in NUMBERS.items():
        if len(prog[stage]) < planned.get(stage, 0):
            nums.update({k: float("inf") for k in names if k in nums})
    return nums


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {name: {value, limit}}: every number at or below its
    limit; a number without a limit fails."""
    table = {k: dict(value=v, limit=limits.get(k)) for k, v in nums.items()}
    ok = all(t["limit"] is not None and t["value"] <= t["limit"] for t in table.values())
    return ok, table

