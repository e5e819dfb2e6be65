"""Copies of what the timed path computes, taken during one job of the
window: the inputs and outputs of chosen calls of the program's stage
functions, cloned on the device (no host read), for the check that runs
once the window has closed.

Stages, each wrapped by the name the program calls it by:
  frontend  batch._lanes_keyframe (one keyframe of every lane): the state
            it starts from (poses, pass ids, node and edge counts), the
            node pose and pass it writes, the closure candidates it picks
            (engine._top_k_ascending), K1's registrations of the pairs
            (ops.icp.icp_align: transform, converged) and the factor rows
            it appends (pair, measurement, square-root information)
  solve     graph.factor_graph.solve_batched (the lane solve)
  dpg       dpg.change_detection.execute_dpg_lanes (one DPG step)
  boundary  batch.batched_increment_pass (the pass boundary)
"""

from __future__ import annotations

import torch

from slambench.instrument import Patches

DPG_FIELDS = ("poses", "pass_ids", "node_active", "ranges", "labels", "sector_active", "cloud", "cloud_mask",
              "num_nodes", "pass_number")
STATE_FIELDS = DPG_FIELDS + ("odom_poses", "cloud_normals")
GRAPH_FIELDS = ("prior_idx", "prior_val", "prior_sqrt_info", "num_priors", "edge_idx", "edge_meas",
                "edge_sqrt_info", "num_edges")


def _clone(x):
    return x.detach().clone() if torch.is_tensor(x) else x


def graph_dict(g) -> dict:
    return {f: _clone(getattr(g, f)) for f in GRAPH_FIELDS}


class Capture:
    """plan: {stage: set of call indices (0-based, in call order)}."""

    def __init__(self, plan: dict):
        self.plan = {k: set(v) for k, v in plan.items()}
        self.calls = {k: 0 for k in ("frontend", "solve", "dpg", "boundary")}
        self.items = {k: [] for k in self.calls}
        self._keyframe = None  # the copy of the keyframe call in progress, if it is kept
        self._patches = Patches()

    def _take(self, stage: str) -> tuple[int, bool]:
        i = self.calls[stage]
        self.calls[stage] += 1
        return i, i in self.plan.get(stage, ())

    def install(self):
        p = self._patches
        p.wrap("batch._lanes_keyframe", self._frontend)
        p.wrap("engine._top_k_ascending", self._candidates)
        p.wrap("ops.icp.icp_align", self._registrations)
        p.wrap("graph.factor_graph.solve_batched", self._solve)
        p.wrap("dpg.change_detection.execute_dpg_lanes", self._dpg)
        p.wrap("batch.batched_increment_pass", self._boundary)
        return self

    def remove(self):
        self._patches.close()

    def _frontend(self, fn):
        def call(cfg, states, odom, ranges, valid):
            i, keep = self._take("frontend")
            if not keep:
                return fn(cfg, states, odom, ranges, valid)
            g = states.graph
            item = dict(call=i, poses=_clone(states.poses), pass_ids=_clone(states.pass_ids),
                        num_nodes=_clone(states.num_nodes), valid=_clone(valid))
            ne = _clone(g.num_edges)
            self._keyframe = item
            try:
                out = fn(cfg, states, odom, ranges, valid)
            finally:
                self._keyframe = None
            S = out.poses.shape[0]
            lane = torch.arange(S, device=out.poses.device)
            new = torch.clamp(item["num_nodes"].long(), max=out.poses.shape[1] - 1)
            item["est_pose"], item["pass_no"] = out.poses[lane, new], out.pass_ids[lane, new]
            # The rows this call appended: a window of 2 + K slots from the
            # lane's edge count on.
            W = 2 + cfg.pose_graph.max_loop_closures_per_node
            slot = torch.clamp(ne.long()[:, None] + torch.arange(W, device=ne.device), max=g.edge_idx.shape[1] - 1)
            og = out.graph
            item["rows"] = dict(idx=og.edge_idx[lane[:, None], slot], meas=og.edge_meas[lane[:, None], slot],
                                sqrt_info=og.edge_sqrt_info[lane[:, None], slot], n=og.num_edges - ne)
            self.items["frontend"].append(item)
            return out
        return call

    def _candidates(self, fn):
        def call(score, k):
            out = fn(score, k)
            if self._keyframe is not None:
                self._keyframe["cand"] = _clone(out)
            return out
        return call

    def _registrations(self, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if self._keyframe is not None:
                self._keyframe.update(transform=_clone(out.transform), converged=_clone(out.converged))
            return out
        return call

    def _solve(self, fn):
        def call(poses, g, node_mask, **kw):
            i, keep = self._take("solve")
            if keep:
                inp = dict(poses=_clone(poses), graph=graph_dict(g), node_mask=_clone(node_mask), kw=dict(kw))
            out = fn(poses, g, node_mask, **kw)
            if keep:
                self.items["solve"].append(dict(call=i, inp=inp, poses=_clone(out[0])))
            return out
        return call

    def _dpg(self, fn):
        def call(cfg, states):
            i, keep = self._take("dpg")
            if keep:
                inp = {f: _clone(getattr(states, f)) for f in DPG_FIELDS}
            new, info = fn(cfg, states)
            if keep:
                self.items["dpg"].append(dict(call=i, inp=inp, out={f: _clone(getattr(new, f))
                                                                    for f in ("labels", "sector_active", "node_active")}))
            return new, info
        return call

    def _boundary(self, fn):
        def call(cfg, states, *a, **kw):
            i, keep = self._take("boundary")
            if keep:
                inp = {f: _clone(getattr(states, f)) for f in STATE_FIELDS}
            out = fn(cfg, states, *a, **kw)
            if keep:
                self.items["boundary"].append(dict(call=i, inp=inp, poses=_clone(out.poses)))
            return out
        return call
