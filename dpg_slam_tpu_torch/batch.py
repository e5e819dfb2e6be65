"""Session-batched mode: S independent sessions through one keyframe loop
— the port of dpg_slam_tpu/batch.py, the mode of record.

A single session's keyframe is a long chain of small operations, and on
the card one session leaves the device mostly idle. Here every step runs
one keyframe of each of S sessions (lanes), with the JAX package's two
moves:

1.  **Host keyframe schedule.** The keyframe gate (shouldProcessLaser,
    dpg_slam.cc:577-589) reads only the odometry stream, so
    `keyframe_schedule` replicates it in numpy and `pack_sessions`
    compacts each session to its keyframes, padded to the longest.
2.  **Cross-session ICP fusion.** Each step assembles every lane's
    (1+K)-pair ICP batch and runs them as one `icp_align` call of
    S·(1+K) pairs: one launch of kernel K1 on the card.

The stacked state is a SlamState whose leaves carry a leading lane axis
S. A step writes each lane's new node row and factor slots in place, at
(lane, row); a padding lane (no keyframe this step) writes back what its
slots hold, so no (S, N, ...) tensor is copied, no index leaves its array
(the JAX package drops out-of-bounds writes instead), and padding lanes
keep their graph and gate scalars. The solve is the lane-batched LM
(`graph.factor_graph.solve_batched`). With the lanes solve methods no
step reads the host: the host reads before the loop (the schedule, the
node bucket) and after it.

The multipass mode (`process_sessions_multipass`) runs the reference's
whole execution model on the lanes: one keyframe loop a pass, with the
lanes' DPG step (`dpg.change_detection.execute_dpg_lanes`, one K1 launch
for every lane's local registration) after every keyframe step of pass
>= 1, and between passes `batched_increment_pass`: every lane's
reoptimize sweep in one K1 launch, then each lane's graph rebuilt and
every lane solved in one lane-axis LM (`fg.solve_lanes`). The pass
boundary reads the host, as the JAX package's does.

The online mode (`BatchedSlamServer`) serves S live streams: the same
keyframe gate runs on the host tick by tick, each lane's gated scan waits
in a buffer, and a bounded-delay batcher runs one batched keyframe step
(`_batched_keyframe_step`, the loop's stride-1 step) when enough lanes are
pending. Its tick loop reads no device value.
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import NamedTuple

import numpy as np
import torch

from dpg_slam_tpu_torch import engine as eng
from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.dpg import change_detection
from dpg_slam_tpu_torch.engine import SlamState
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.ops import icp
from dpg_slam_tpu_torch.utils import profiling

__all__ = [
    "BatchedSlamServer",
    "batched_increment_pass",
    "keyframe_schedule",
    "pack_sessions",
    "process_sessions_batched",
    "process_sessions_multipass",
    "session_state",
]

_LANES_METHODS = ("lanes_chol", "lanes_cg")


def keyframe_schedule(cfg: DpgConfig, odometry: np.ndarray) -> np.ndarray:
    """Host (numpy) replica of the keyframe gate over one odometry stream
    (`_observe_odometry` + `_should_process`): the first scan of a pass
    always processes; afterwards a scan processes when the odometry
    distance since the last keyframe exceeds min_dist_between_nodes or its
    heading change exceeds min_angle_between_nodes. Returns the (T,) bool
    keyframe mask."""
    pg = cfg.pose_graph
    odom = np.asarray(odometry, np.float64)
    T = odom.shape[0]
    mask = np.zeros((T,), bool)
    initialized = False
    odom_at_last = np.zeros(3)
    cum = 0.0
    first = True
    for t in range(T):
        o = odom[t]
        if initialized:
            cum += float(np.hypot(o[0] - odom_at_last_obs[0], o[1] - odom_at_last_obs[1]))
        else:
            odom_at_last = o  # the first odometry fixes the gate's frame
            initialized = True
        odom_at_last_obs = o
        ang = abs(np.angle(np.exp(1j * (o[2] - odom_at_last[2]))))
        if first or cum > pg.min_dist_between_nodes or ang > pg.min_angle_between_nodes:
            mask[t] = True
            first = False
            cum = 0.0
            odom_at_last = o
    return mask


def pack_sessions(cfg: DpgConfig, sessions: list[tuple[np.ndarray, np.ndarray]], max_keyframes: int | None = None):
    """Compact S sessions' scan streams to their keyframes and pad them to
    a common length, time-major.

    sessions: (odometry (T_s, 3), scans (T_s, B)) per session;
    max_keyframes: cap per session (default: node capacity). Each session
    is also capped by a worst-case edge budget (2 + K edges a keyframe),
    with a warning where that cap binds.

    Returns host arrays (kf_odom (Km, S, 3) f32, kf_scans (Km, S, B) f32,
    kf_valid (Km, S) bool) and the per-session keyframe counts."""
    cap_nodes = cfg.capacity.max_nodes if max_keyframes is None else max_keyframes
    edges_worst = 2 + cfg.pose_graph.max_loop_closures_per_node
    # Conservative: the sequential engine's live gate counts the edges a
    # keyframe actually added, so on edge-tight configs lanes can stop
    # earlier than the engine would.
    edges_cap = cfg.capacity.max_edges // edges_worst
    cap = min(cap_nodes, edges_cap)
    B = cfg.scan.num_beams
    kf_os, kf_ss, counts = [], [], []
    for si, (odom, scans) in enumerate(sessions):
        odom = np.asarray(odom, np.float32)
        scans = np.asarray(scans, np.float32)
        if scans.shape[1] != B:
            raise ValueError(f"expected (T, {B}) scans, got {scans.shape}")
        idx_all = np.nonzero(keyframe_schedule(cfg, odom))[0]
        if len(idx_all) > cap and edges_cap < cap_nodes:
            warnings.warn(
                f"pack_sessions: session {si} truncated to {cap} keyframes by the worst-case "
                f"edge budget (max_edges // {edges_worst}); the sequential engine's live gate may "
                "have accepted more; raise capacity.max_edges for exact per-lane parity",
                stacklevel=2,
            )
        idx = idx_all[:cap]
        kf_os.append(odom[idx])
        kf_ss.append(scans[idx])
        counts.append(len(idx))
    Km = max(counts)
    S = len(sessions)
    kf_odom = np.zeros((Km, S, 3), np.float32)
    kf_scans = np.zeros((Km, S, B), np.float32)
    kf_valid = np.zeros((Km, S), bool)
    for s in range(S):
        n = counts[s]
        kf_odom[:n, s] = kf_os[s]
        kf_scans[:n, s] = kf_ss[s]
        kf_valid[:n, s] = True
    return kf_odom, kf_scans, kf_valid, counts


# ---------------------------------------------------------------------------
# Stacked states
# ---------------------------------------------------------------------------

def _tree_map(fn, state):
    """fn over every tensor of a SlamState (graph included)."""
    return type(state)(*(_tree_map(fn, x) if hasattr(x, "_fields") else fn(x) for x in state))


def _stack_states(cfg: DpgConfig, n_sessions: int, device="cuda") -> SlamState:
    """n_sessions fresh session states stacked on a leading lane axis."""
    return _tree_map(lambda x: x.unsqueeze(0).repeat((n_sessions,) + (1,) * x.ndim), eng._init_state(cfg, device))


def session_state(states: SlamState, i: int) -> SlamState:
    """Lane i of a stacked SlamState (views of its tensors)."""
    return _tree_map(lambda x: x[i], states)


# ---------------------------------------------------------------------------
# One keyframe of every lane
# ---------------------------------------------------------------------------

def _put_rows(t: torch.Tensor, lane: torch.Tensor, row: torch.Tensor, valid: torch.Tensor, value) -> None:
    """t[lane, row] = value in place for valid lanes; the others write
    back their own row."""
    old = t[lane, row]
    t[lane, row] = torch.where(valid.view((-1,) + (1,) * (old.ndim - 1)), value, old)


class _Append(NamedTuple):
    """Where each lane's kept rows land in a fixed-capacity factor array,
    packed into consecutive slots from the lane's count on (the packing
    of fg.add_between_batch)."""

    order: torch.Tensor  # (S, W) each row's place in the packed window: kept rows first, in order
    write: torch.Tensor  # (S, W) window slot j takes a kept row and lies inside the capacity
    slot: torch.Tensor   # (S, W) target slot, clamped into the capacity
    src: torch.Tensor    # (S, W) window entry each target slot takes its value from
    count: torch.Tensor  # (S,) int32 kept rows; the count grows by all of them


def _append_plan(count: torch.Tensor, keep: torch.Tensor, cap: int) -> _Append:
    S, W = keep.shape
    win = torch.arange(W, device=keep.device)
    k = keep.to(torch.int64)
    n = k.sum(dim=1)
    slot = count.to(torch.int64)[:, None] + win
    # Window slots past the capacity are dropped (as add_between_batch
    # drops them); clamped, they all land on slot cap - 1 and take the
    # value of the window entry that owns it, so every write there agrees.
    src = torch.clamp(torch.minimum(win, cap - 1 - count.to(torch.int64)[:, None]), min=0)
    return _Append(
        order=torch.where(keep, torch.cumsum(k, dim=1) - k, W + win),
        write=(win < n[:, None]) & (slot < cap),
        slot=torch.clamp(slot, max=cap - 1),
        src=src,
        count=n.to(torch.int32),
    )


def _append_rows(t: torch.Tensor, plan: _Append, rows: torch.Tensor) -> None:
    """Write (S, W, ...) rows into t (S, cap, ...) in place by plan."""
    S, W = plan.order.shape
    lane = torch.arange(S, device=t.device)[:, None]
    tail = (1,) * (rows.ndim - 2)
    packed = torch.zeros((S, 2 * W) + rows.shape[2:], dtype=t.dtype, device=t.device)
    packed.scatter_(1, plan.order.view((S, W) + tail).expand(rows.shape), rows.to(t.dtype))
    new = torch.where(plan.write.view((S, W) + tail), packed[:, :W], t[lane, plan.slot])
    t[lane, plan.slot] = torch.take_along_dim(new, plan.src.view((S, W) + tail), dim=1)


class _Nodes(NamedTuple):
    """What the node segment (_kf_nodes) leaves to the rest of the step."""

    lane: torch.Tensor        # (S,) arange
    prev_odom: torch.Tensor   # (S, 3) the step's odometry
    is_first: torch.Tensor    # (S,) a lane's first scan of its pass
    new_idx: torch.Tensor     # (S,) int64 the new node's row
    prec: torch.Tensor        # (S,) new_idx - 1
    odom_displ: torch.Tensor  # (S, 3) odometry since the last node
    est_pose: torch.Tensor    # (S, 3) the new node's pose estimate
    pts: torch.Tensor         # (S, P, 2) the new node's cloud
    mask: torch.Tensor        # (S, P)
    cand_ok: torch.Tensor     # (S, N) node slots a closure may target
    score: torch.Tensor       # (S, N) distance where cand_ok, else inf


class _Pairs(NamedTuple):
    """What the pair segment (_kf_pairs) leaves to the rest of the step."""

    tgt_idx: torch.Tensor      # (S, 1+K) successive node, then the candidates
    tgt_valid: torch.Tensor    # (S, 1+K)
    tgt_pose: torch.Tensor     # (S, 1+K, 3)
    succ: torch.Tensor         # (1+K,) the successive slot
    pairs: tuple               # icp_align's five positional inputs, S·(1+K) pairs
    tgt_normals: torch.Tensor  # (S·(1+K), P, 2)
    gate: torch.Tensor         # (S·(1+K),)


def _kf_nodes(cfg: DpgConfig, states: SlamState, odom: torch.Tensor, ranges: torch.Tensor,
              valid: torch.Tensor) -> _Nodes:
    """The step up to the closure candidates' scores: odometry, pose
    estimate, node writes, distances to every node."""
    pg = cfg.pose_graph
    S, N = states.poses.shape[:2]
    dev = states.poses.device
    lane = torch.arange(S, device=dev)
    obs = eng._observe_odometry(cfg, states, odom)
    is_first = obs.first_scan_for_pass
    new_idx = obs.num_nodes.to(torch.int64)
    prec = new_idx - 1  # -1 at a lane's first node: indexes the last slot, its pairs gated out

    # Pose estimate and node write (createNode, dpg_slam.cc:488-513).
    odom_displ = geom.between(obs.odom_at_last_node, obs.prev_odom)
    prev_pose = torch.where((new_idx > 0)[:, None], states.poses[lane, torch.clamp(prec, min=0)], 0.0)
    est_pose = torch.where(is_first[:, None], 0.0, geom.compose(prev_pose, odom_displ))
    labels, pts, mask, normals = eng._prepare_cloud(cfg, ranges)
    row = torch.clamp(new_idx, max=N - 1)
    for name, value in (
        ("poses", est_pose), ("odom_poses", obs.prev_odom), ("pass_ids", obs.pass_number),
        ("node_active", True), ("ranges", ranges), ("labels", labels), ("sector_active", True),
        ("cloud", pts), ("cloud_mask", mask), ("cloud_normals", normals),
    ):
        _put_rows(getattr(states, name), lane, row, valid, value)

    # Successive pair + top-K loop-closure candidates (_icp_pairs_for_new_node).
    dist = torch.linalg.norm(states.poses[..., 0:2] - est_pose[:, None, 0:2], dim=-1)
    same_pass = states.pass_ids == obs.pass_number[:, None]
    thr = torch.where(
        same_pass,
        pg.maximum_node_dist_within_pass_scan_comparison,
        pg.maximum_node_dist_across_passes_scan_comparison,
    )
    idx = torch.arange(N, device=dev)
    gap_ok = ~same_pass | (new_idx[:, None] - idx >= pg.min_loop_closure_node_gap)
    cand_ok = (idx < prec[:, None]) & (dist <= thr) & gap_ok
    return _Nodes(lane, obs.prev_odom, is_first, new_idx, prec, odom_displ, est_pose, pts, mask, cand_ok,
                  torch.where(cand_ok, dist, float("inf")))


def _kf_pairs(cfg: DpgConfig, states: SlamState, valid: torch.Tensor, n: _Nodes, cand_idx: torch.Tensor) -> _Pairs:
    """Every lane's (1+K) ICP pairs from the candidates cand_idx (S, K)."""
    pg = cfg.pose_graph
    K1 = 1 + pg.max_loop_closures_per_node
    S = states.poses.shape[0]
    dev = states.poses.device
    tgt_idx = torch.cat([n.prec[:, None], cand_idx], dim=1)
    tgt_valid = torch.cat(
        [torch.ones((S, 1), dtype=torch.bool, device=dev), torch.gather(n.cand_ok, 1, cand_idx)], dim=1
    )
    at = (n.lane[:, None], tgt_idx)
    tgt_pose = states.poses[at]
    succ = torch.arange(K1, device=dev) == 0
    gate = torch.where(succ, 1.0, pg.icp_coarse_gate_multiplier).expand(S, K1)
    src_mask = n.mask & valid[:, None]

    def flat(x):
        return x.reshape((S * K1,) + x.shape[2:])

    pairs = (
        flat(n.pts[:, None].expand(S, K1, -1, -1)),
        flat(src_mask[:, None].expand(S, K1, -1)),
        flat(states.cloud[at]),
        flat(states.cloud_mask[at] & tgt_valid[..., None] & valid[:, None, None]),
        flat(geom.between(tgt_pose, n.est_pose[:, None].expand(S, K1, 3))),
    )
    return _Pairs(tgt_idx, tgt_valid, tgt_pose, succ, pairs, flat(states.cloud_normals[at]), flat(gate))


def _kf_factors(cfg: DpgConfig, states: SlamState, valid: torch.Tensor, n: _Nodes, p: _Pairs,
                transform: torch.Tensor, converged: torch.Tensor, covariance: torch.Tensor) -> SlamState:
    """The closure vote and the factor appends from K1's registrations
    (S·(1+K) rows of transform, converged, covariance); returns the state
    with the new counts and gate scalars."""
    pg = cfg.pose_graph
    K1 = 1 + pg.max_loop_closures_per_node
    S = states.poses.shape[0]
    dev = states.poses.device
    transform = transform.view(S, K1, 3)
    converged = converged.view(S, K1)

    # Closure gating and vote (_keyframe_frontend_post).
    tgt_valid = p.tgt_valid & (n.new_idx > 0)[:, None]
    if not pg.non_successive_scan_constraints:
        tgt_valid = tgt_valid & p.succ
    if pg.closure_consistency_transl is not None:
        voted = eng._closure_consistency_votes(
            cfg, p.tgt_pose[:, 1:], transform[:, 1:], n.est_pose, tgt_valid[:, 1:] & converged[:, 1:]
        )
        tgt_valid = torch.cat([tgt_valid[:, :1], voted], dim=1)

    # Factors: the prior of a pass-first node, then the odometry factor and
    # the observation factors (successive always, closures when
    # converged), in the single-stream engine's slot order.
    g = states.graph
    pplan = _append_plan(g.num_priors, (n.is_first & valid)[:, None], g.prior_idx.shape[1])
    prior_si = fg.sqrt_info_from_sigmas(eng._prior_sigmas(cfg, dev))
    _append_rows(g.prior_idx, pplan, n.new_idx[:, None])
    _append_rows(g.prior_val, pplan, torch.zeros((S, 1, 3), device=dev))
    _append_rows(g.prior_sqrt_info, pplan, prior_si.expand(S, 1, 3, 3))
    odo_keep = ~n.is_first & pg.odometry_constraints
    keep = torch.cat([odo_keep[:, None], tgt_valid & (converged | p.succ)], dim=1) & valid[:, None]
    eplan = _append_plan(g.num_edges, keep, g.edge_idx.shape[1])
    pair = torch.stack([torch.cat([n.prec[:, None], p.tgt_idx], dim=1), n.new_idx[:, None].expand(S, K1 + 1)],
                       dim=-1)
    odo_si = fg.sqrt_info_from_sigmas(eng._motion_model_sigmas(cfg, n.odom_displ))
    _append_rows(g.edge_idx, eplan, pair)
    _append_rows(g.edge_meas, eplan, torch.cat([n.odom_displ[:, None], transform], dim=1))
    _append_rows(
        g.edge_sqrt_info, eplan,
        torch.cat([odo_si[:, None], fg.sqrt_info_from_covariance(covariance).view(S, K1, 3, 3)], dim=1),
    )

    v3 = valid[:, None]
    return states._replace(
        graph=g._replace(num_priors=g.num_priors + pplan.count, num_edges=g.num_edges + eplan.count),
        num_nodes=states.num_nodes + valid.to(torch.int32),
        prev_odom=torch.where(v3, n.prev_odom, states.prev_odom),
        odom_at_last_node=torch.where(v3, n.prev_odom, states.odom_at_last_node),
        cumulative_dist=torch.where(valid, 0.0, states.cumulative_dist),
        odom_initialized=states.odom_initialized | valid,
        first_scan_for_pass=states.first_scan_for_pass & ~valid,
    )


# The fields a keyframe step replaces rather than writes in place: the
# counts and the gate scalars.
_GATE_FIELDS = ("num_nodes", "prev_odom", "odom_at_last_node", "cumulative_dist", "odom_initialized",
                "first_scan_for_pass")


def _step_scalars(states: SlamState) -> list[torch.Tensor]:
    return [getattr(states, f) for f in _GATE_FIELDS] + [states.graph.num_priors, states.graph.num_edges]


def _own_step_scalars(states: SlamState) -> SlamState:
    """states with copies of its counts and gate scalars."""
    *gate, num_priors, num_edges = (x.clone() for x in _step_scalars(states))
    return states._replace(graph=states.graph._replace(num_priors=num_priors, num_edges=num_edges),
                           **dict(zip(_GATE_FIELDS, gate)))


def _leaves(states: SlamState) -> list[torch.Tensor]:
    return [x for f in states for x in (f if hasattr(f, "_fields") else (f,))]


class _Eager:
    """Runs the keyframe step's segments as they come."""

    def put(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def run(self, i: int, fn, *args):
        return fn(*args)

    def adopt(self, states: SlamState, new: SlamState) -> SlamState:
        return new


_EAGER = _Eager()

# Fewest keyframe steps for which a loop captures its step (fewer run
# eagerly). On an H100 the capture step costs the host 21-38 ms more than
# a replay, and a replay (~1.9 ms) saves ~8 ms on an eager step (~10 ms):
# graphs pay from 4 steps at the fleet configuration, from 6 at the
# multipass one (PERF.md §6).
_GRAPH_MIN_STEPS = 6


class _KeyframeGraphs:
    """The keyframe step of one keyframe loop, replayed from CUDA graphs:
    the three segments (_kf_nodes, _kf_pairs, _kf_factors) each captured
    once into one private memory pool, with the candidate sort and the
    ICP call run eagerly between them, by their module names, every step.

    The loop's first step runs eagerly (it makes the constants, handles
    and allocator blocks the step uses). The second captures the segments
    on its own state tensors, the node and factor arrays that every step
    writes in place, after giving the step's counts and gate scalars
    buffers of their own that the last segment writes back into; then it
    and every later step replay them. Each replay first copies the step's
    inputs into the captured ones: odom, ranges and valid, the sorted
    candidates, K1's transform, converged and covariance. A state whose
    tensors are not the captured ones runs eagerly."""

    def __init__(self, states: SlamState):
        self._warm = False
        self._leaves: list[torch.Tensor] | None = None
        self._bufs: dict[str, torch.Tensor] = {}
        self._graphs: dict[int, tuple] = {}
        self._pool = None
        self._stream = torch.cuda.Stream(states.poses.device)

    @staticmethod
    def engage(states: SlamState, steps: int) -> "_KeyframeGraphs | None":
        """Graphs for a loop of `steps` keyframe steps over `states`: on a
        CUDA device from _GRAPH_MIN_STEPS steps on, else None (eager)."""
        return _KeyframeGraphs(states) if states.poses.is_cuda and steps >= _GRAPH_MIN_STEPS else None

    def runner(self, states: SlamState) -> tuple:
        """(runner, states) for one step: _EAGER at the warm-up step and
        for a state whose tensors are not the captured ones, else self,
        capturing now if nothing is captured yet (on states with buffers
        of their own for the counts and gate scalars)."""
        if not self._warm:
            self._warm = True
            return _EAGER, states
        if self._leaves is None:
            states = _own_step_scalars(states)
            self._leaves = _leaves(states)
            profiling.count("batch.keyframe_graph_captures")
        elif any(a is not b for a, b in zip(_leaves(states), self._leaves, strict=True)):
            return _EAGER, states
        profiling.count("batch.keyframe_graph_replays")
        return self, states

    def put(self, name: str, x: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None:
            buf = self._bufs[name] = torch.empty_like(x)
        return buf.copy_(x)

    def run(self, i: int, fn, *args):
        """Segment i: captured from fn(*args) the first time, then replayed;
        returns the captured outputs."""
        if i not in self._graphs:
            graph = torch.cuda.CUDAGraph()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    out = fn(*args)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(self._stream)
            self._pool = graph.pool()
            self._graphs[i] = (graph, out)
        graph, out = self._graphs[i]
        graph.replay()
        return out

    def adopt(self, states: SlamState, new: SlamState) -> SlamState:
        """new's counts and gate scalars written into states' buffers."""
        for buf, x in zip(_step_scalars(states), _step_scalars(new), strict=True):
            buf.copy_(x)
        return states


# The open keyframe loop's graphs (_KeyframeGraphs or None): set by
# _process_sessions_batched for the length of its loop. _lanes_keyframe
# finds them here, since its callers and the wrappers around it know it by
# its five arguments.
_LOOP_GRAPHS: contextvars.ContextVar = contextvars.ContextVar("keyframe_graphs", default=None)


@contextlib.contextmanager
def _loop_graphs(graphs: _KeyframeGraphs | None):
    token = _LOOP_GRAPHS.set(graphs)
    try:
        yield
    finally:
        _LOOP_GRAPHS.reset(token)


def _lanes_keyframe(cfg: DpgConfig, states: SlamState, odom: torch.Tensor, ranges: torch.Tensor,
                    valid: torch.Tensor) -> SlamState:
    """One keyframe of every valid lane (engine._keyframe_frontend per
    lane, without the solve): odom (S, 3), ranges (S, B), valid (S,).
    The node rows and factor slots of `states` are written in place; the
    returned state carries the new counts and gate scalars. All lanes'
    ICP pairs go through one icp_align call; a padding lane's pairs have
    every point masked and their results are not used.

    The step is three segments (_kf_nodes, _kf_pairs, _kf_factors) around
    two calls made every step by their module names:
    engine._top_k_ascending (the closure candidates) and icp.icp_align
    (K1). Inside a keyframe loop on the card the segments replay from CUDA
    graphs (_KeyframeGraphs); elsewhere they run eagerly. Replayed, the
    sort's scores and the ICP call's inputs are the graphs' buffers, which
    the next step rewrites: a caller that keeps them keeps copies."""
    with profiling.span("batch.keyframe"):
        graphs = _LOOP_GRAPHS.get()
        run, states = graphs.runner(states) if graphs is not None else (_EAGER, states)
        pg = cfg.pose_graph
        odom, ranges, valid = run.put("odom", odom), run.put("ranges", ranges), run.put("valid", valid)
        with profiling.span("batch.keyframe.nodes"):
            n = run.run(0, _kf_nodes, cfg, states, odom, ranges, valid)
        with profiling.span("batch.keyframe.candidates"):
            cand_idx = run.put("cand_idx", eng._top_k_ascending(n.score, pg.max_loop_closures_per_node))
            p = run.run(1, _kf_pairs, cfg, states, valid, n, cand_idx)
        res = icp.icp_align(*p.pairs, pg, tgt_normals=p.tgt_normals, gate_multiplier=p.gate)
        with profiling.span("batch.keyframe.factors"):
            reg = (run.put("transform", res.transform), run.put("converged", res.converged),
                   run.put("covariance", res.covariance))
            return run.run(2, lambda *a: run.adopt(states, _kf_factors(*a)), cfg, states, valid, n, p, *reg)


# ---------------------------------------------------------------------------
# The solve and the loop
# ---------------------------------------------------------------------------

def _solve_choice(cfg: DpgConfig, bucket: int) -> str:
    """Default solve: the lane-batched LM with Cholesky up to a 128-node
    bucket, fixed-iteration PCG above; the engine's block-sparse CG per
    lane past 1,024 node slots (the dense assembly's cliff)."""
    if cfg.capacity.max_nodes > 1024:
        return "cg"
    return "lanes_chol" if bucket <= 128 else "lanes_cg"


def _check_method(method: str) -> None:
    if method in ("dense", "dense_cg"):
        raise ValueError(
            f"solve_method {method!r}: the vmapped engine solves are on ROADMAP.md's list of "
            "code the port does not carry; use 'lanes_chol', 'lanes_cg' or 'cg'"
        )
    if method not in _LANES_METHODS + ("cg",):
        raise ValueError(f"unknown batched solve method {method!r}")


def _batched_solve(cfg: DpgConfig, states: SlamState, solve_method: str, nb: int,
                   gn_iterations: int | None = None, cg_iterations: int | None = None) -> torch.Tensor:
    """Every lane's warm-started solve on node slots [:nb] (the engine's
    solve settings); returns the (S, nb, 3) poses. "lanes_chol" /
    "lanes_cg" run fg.solve_batched; "cg" runs the engine's
    _keyframe_solve lane by lane (it reads the host)."""
    pg = cfg.pose_graph
    if solve_method == "cg":
        return torch.stack([
            eng._keyframe_solve(cfg, session_state(states, i), "cg", nb).poses[:nb]
            for i in range(states.poses.shape[0])
        ])
    node_mask = torch.arange(nb, device=states.poses.device) < states.num_nodes[:, None]
    poses, _ = fg.solve_batched(
        states.poses[:, :nb],
        states.graph,
        node_mask,
        max_iterations=pg.incremental_gn_iterations if gn_iterations is None else gn_iterations,
        damping_init=pg.gn_damping_init,
        method="chol" if solve_method == "lanes_chol" else "cg_fixed",
        cg_iterations=12 if cg_iterations is None else cg_iterations,
        robust_delta=pg.robust_delta,
        gradient_tol=pg.gn_gradient_tol,
        terminate_on_reject=True,
        rel_tol=1e-4,
    )
    return poses


def _adopt_solve(cfg: DpgConfig, states: SlamState, live: torch.Tensor, solve_method: str, nb: int,
                 gn_iterations: int | None = None, cg_iterations: int | None = None) -> SlamState:
    """Every lane's solve on node slots [:nb] (_batched_solve), adopted
    in place on the lanes where `live` (S,) is set."""
    with profiling.span("batch.solve"):
        solved = _batched_solve(cfg, states, solve_method, nb, gn_iterations, cg_iterations)
        states.poses[:, :nb] = torch.where(live[:, None, None], solved, states.poses[:, :nb])
        return states


def _batched_keyframe_step(cfg: DpgConfig, states: SlamState, odom: torch.Tensor, ranges: torch.Tensor,
                           valid: torch.Tensor, solve_method: str, solve_bucket: int | None = None,
                           gn_iterations: int | None = None, cg_iterations: int | None = None) -> SlamState:
    """ONE batched keyframe step (the JAX package's
    _batched_keyframe_step): the frontend of every valid lane
    (_lanes_keyframe; odom (S, 3), ranges (S, B), valid (S,)), then every
    lane's solve on node slots [:solve_bucket] (default: all), its poses
    adopted where `valid`. The loop's stride-1 step and the server's step.

    `states`' tensors are written in place, as _lanes_keyframe writes
    them. With "lanes_chol" / "lanes_cg" the step reads no host value;
    "cg" runs the engine's solve lane by lane, which reads the host every
    LM iteration."""
    nb = solve_bucket or states.poses.shape[1]
    states = _lanes_keyframe(cfg, states, odom, ranges, valid)
    return _adopt_solve(cfg, states, valid, solve_method, nb, gn_iterations, cg_iterations)


def _lanes_dpg(cfg: DpgConfig, states: SlamState, valid: torch.Tensor) -> SlamState:
    """The DPG step on every lane (change_detection.execute_dpg_lanes),
    its labels, sector_active and node_active adopted in place where
    `valid` (the lanes that took a keyframe this step): the keyframe
    loop's graphs read those tensors where they are. Nothing else
    changes."""
    with profiling.span("batch.dpg"):
        new, _ = change_detection.execute_dpg_lanes(cfg, states)
        for f in ("labels", "sector_active", "node_active"):
            old = getattr(states, f)
            torch.where(valid.view((-1,) + (1,) * (old.ndim - 1)), getattr(new, f), old, out=old)
        return states


def _process_sessions_batched(
    cfg: DpgConfig,
    states: SlamState,
    kf_odom: torch.Tensor,   # (Km, S, 3) time-major keyframe odometry
    kf_scans: torch.Tensor,  # (Km, S, B)
    kf_valid: torch.Tensor,  # (Km, S) bool, False on padding steps
    solve_method: str,
    solve_bucket: int | None = None,
    solve_stride: int = 1,
    solve_gn_iterations: int | None = None,
    solve_cg_iterations: int | None = None,
    run_dpg: bool = False,
) -> SlamState:
    """The keyframe loop: each step runs one keyframe of every lane; the
    solve runs after every `solve_stride` steps over each lane with a
    keyframe in that group (1 = the reference's solve per keyframe; the
    last group's solve covers the whole graph). Km must divide by the
    stride. run_dpg adds the lanes' DPG step after every keyframe step, in
    the JAX package's order: after the solve at stride 1, before the
    group's solve above it. Updates `states`' tensors in place. The loop
    is the span batch.loop; it adds its steps and steps x lanes to the
    counters batch.steps and batch.lane_steps.

    On a CUDA device a loop of _GRAPH_MIN_STEPS steps or more replays its
    keyframe steps from CUDA graphs (_KeyframeGraphs: one capture, at the
    second step, counted by batch.keyframe_graph_captures, and a replay a
    step from there, by batch.keyframe_graph_replays); the returned
    state's counts and gate scalars are its own copies."""
    Km, S = kf_valid.shape
    if Km % solve_stride:
        raise ValueError(f"{Km} keyframe steps do not divide by solve_stride {solve_stride}")
    profiling.count("batch.steps", Km)
    profiling.count("batch.lane_steps", Km * S)
    nb = solve_bucket or states.poses.shape[1]
    its = (solve_gn_iterations, solve_cg_iterations)
    graphs = _KeyframeGraphs.engage(states, Km)
    with profiling.span("batch.loop"), _loop_graphs(graphs):
        for g0 in range(0, Km, solve_stride):
            if solve_stride == 1:
                states = _batched_keyframe_step(cfg, states, kf_odom[g0], kf_scans[g0], kf_valid[g0], solve_method, nb,
                                                *its)
                if run_dpg:
                    states = _lanes_dpg(cfg, states, kf_valid[g0])
                continue
            for k in range(g0, g0 + solve_stride):
                states = _lanes_keyframe(cfg, states, kf_odom[k], kf_scans[k], kf_valid[k])
                if run_dpg:
                    states = _lanes_dpg(cfg, states, kf_valid[k])
            states = _adopt_solve(cfg, states, kf_valid[g0:g0 + solve_stride].any(dim=0), solve_method, nb, *its)
    # The captured buffers of the counts and gate scalars stay with the graphs.
    return states if graphs is None else _own_step_scalars(states)


def process_sessions_batched(
    cfg: DpgConfig,
    sessions: list[tuple[np.ndarray, np.ndarray]],
    solve_bucket: int | None = None,
    solve_method: str | None = None,
    solve_stride: int = 1,
    solve_gn_iterations: int | None = None,
    solve_cg_iterations: int | None = None,
    device="cuda",
) -> tuple[SlamState, list[int]]:
    """Run S independent sessions through the batched keyframe loop on
    `device` (the card unless the caller names another).

    sessions: (odometry (T_s, 3), scans (T_s, B)) per session.
    solve_bucket: node slots the solve runs on (default: the smallest
    engine bucket, a power of two from 64, above the longest session's
    keyframe count). solve_method: "lanes_chol" / "lanes_cg" (the
    lane-batched LM) or "cg" (the engine's solve per lane); default
    _solve_choice. solve_stride: keyframes per solve (the step count is
    padded to a multiple). solve_gn_iterations / solve_cg_iterations: the
    lanes solve's iteration caps (default: the config's
    incremental_gn_iterations / 12).

    Returns (the stacked SlamState, per-session keyframe counts).
    """
    with profiling.job():
        with profiling.span("batch.schedule"):
            states = _stack_states(cfg, len(sessions), device)
            steps, counts, bucket, method = _schedule(cfg, sessions, solve_bucket, solve_method, solve_stride)
            steps = [torch.as_tensor(x, device=device) for x in steps]
        profiling.count("batch.keyframes", sum(counts))
        states = _process_sessions_batched(
            cfg, states, *steps, method, bucket, solve_stride, solve_gn_iterations, solve_cg_iterations,
        )
        return states, counts


def _packed_steps(cfg: DpgConfig, sessions, solve_stride: int):
    """pack_sessions' steps (kf_odom, kf_scans, kf_valid) padded to a
    multiple of the stride, and the keyframe counts."""
    kf_odom, kf_scans, kf_valid, counts = pack_sessions(cfg, sessions)
    pad = (-kf_odom.shape[0]) % solve_stride
    if pad:
        kf_odom = np.concatenate([kf_odom, np.zeros((pad,) + kf_odom.shape[1:], np.float32)])
        kf_scans = np.concatenate([kf_scans, np.zeros((pad,) + kf_scans.shape[1:], np.float32)])
        kf_valid = np.concatenate([kf_valid, np.zeros((pad,) + kf_valid.shape[1:], bool)])
    return (kf_odom, kf_scans, kf_valid), counts


def _node_bucket(cfg: DpgConfig, n_slots: int) -> int:
    """The smallest engine bucket, a power of two from 64, of at least
    n_slots node slots, capped at the node capacity."""
    bucket = 64
    while bucket < n_slots:
        bucket *= 2
    return min(bucket, cfg.capacity.max_nodes)


def _schedule(cfg: DpgConfig, sessions, solve_bucket: int | None, solve_method: str | None, solve_stride: int):
    """The host's work before the loop: the packed keyframe steps
    (kf_odom, kf_scans, kf_valid) padded to a multiple of the stride, the
    keyframe counts, the node bucket and the solve method."""
    steps, counts = _packed_steps(cfg, sessions, solve_stride)
    bucket = _node_bucket(cfg, max(counts) + 1) if solve_bucket is None else solve_bucket
    method = solve_method or _solve_choice(cfg, bucket)
    _check_method(method)
    return steps, counts, bucket, method


# ---------------------------------------------------------------------------
# Multi-pass: the pass boundary of every lane, and the passes
# ---------------------------------------------------------------------------

def batched_increment_pass(cfg: DpgConfig, states: SlamState, solve_method: str = "dense") -> SlamState:
    """Every lane's pass boundary (DpgSlamEngine.increment_pass per lane,
    dpg_data_runner_main.cc:30-52): the global reoptimize, then pass_number
    + 1, the first-scan flag set, the odometry gate re-anchored.

    The host reads num_nodes, poses and pass_ids of all lanes once and
    compacts each lane's live pairs (as the engine does), padded to a
    common count B on a common power-of-two node bucket. Every lane's
    compacted sweep goes into one icp_align call of S·B pairs (one K1
    launch on the card); each lane's results are scattered back and its
    graph rebuilt (engine._reoptimize_graph), then the S graphs are solved
    on the lane axis in one fg.solve_lanes call (the engine's fg.solve
    settings; JAX vmaps its solve's while_loop the same way). Raises
    RuntimeError where a lane's factor candidates overflow the edge
    capacity.

    The boundary is the span batch.boundary, its phases boundary.read,
    boundary.inputs, icp.align, boundary.rebuild and graph.solve_lanes;
    each explicit host read adds 1 to the counter host.reads. The sweep's
    live pairs (summed over the lanes' compactions) and its S·B slots add
    to the counters boundary.sweep_pairs and boundary.sweep_slots."""
    with profiling.span("batch.boundary"):
        S = states.poses.shape[0]
        dev = states.poses.device
        with profiling.span("boundary.read"):
            num_nodes = states.num_nodes.cpu().numpy()
            nb = _node_bucket(cfg, int(num_nodes.max()))
            poses_h = states.poses[:, :nb].cpu().numpy()
            pass_ids_h = states.pass_ids[:, :nb].cpu().numpy()
            profiling.count("host.reads", 3)
            compacted = [
                eng._reoptimize_compaction_host(cfg, poses_h[s], pass_ids_h[s], int(num_nodes[s]), nb)
                for s in range(S)
            ]
            B = max(idx.shape[0] for idx, _, _ in compacted)
            profiling.count("boundary.sweep_pairs", sum(n_live for _, _, n_live in compacted))
            profiling.count("boundary.sweep_slots", S * B)
            ci = np.zeros((S, B), np.int64)
            cv = np.zeros((S, B), bool)
            for s, (idx, val, _) in enumerate(compacted):
                ci[s, : idx.shape[0]] = idx
                cv[s, : val.shape[0]] = val
            ci, cv = torch.as_tensor(ci, device=dev), torch.as_tensor(cv, device=dev)

        with profiling.span("boundary.inputs"):
            lanes = [session_state(states, s) for s in range(S)]
            pairs, args, kwargs, cval = zip(*(
                eng._reoptimize_icp_inputs(cfg, eng._reoptimize_bucket(lanes[s], nb), ci[s], cv[s]) for s in range(S)
            ))
            sweep = [torch.cat(planes) for planes in zip(*(a[:5] for a in args))]
            sweep_kw = {k: torch.cat([kw[k] for kw in kwargs]) for k in kwargs[0]}
        res = icp.icp_align(*sweep, cfg.pose_graph, **sweep_kw)

        with profiling.span("boundary.rebuild"):
            graphs = []
            E = cfg.capacity.max_edges
            for s in range(S):
                lane_res = icp.ICPResult(*(x[s * B:(s + 1) * B] for x in res))
                g, n_edge_cand = eng._reoptimize_graph(cfg, eng._reoptimize_bucket(lanes[s], nb), pairs[s], ci[s],
                                                       cval[s], lane_res)
                # The engine's host bound: the candidate count is read only
                # where it can overflow.
                if int(num_nodes[s]) - 1 + compacted[s][2] > E:
                    profiling.count("host.reads")
                    if int(n_edge_cand) > E:
                        raise RuntimeError(
                            f"lane {s}: reoptimize produced {int(n_edge_cand)} factor candidates but edge capacity "
                            f"is {E}"
                        )
                graphs.append(g)
            graph = fg.FactorGraph(*(torch.stack(x) for x in zip(*graphs)))
        node_mask = torch.arange(nb, device=dev) < states.num_nodes[:, None]
        poses_b, _ = fg.solve_lanes(states.poses[:, :nb], graph, node_mask,
                                    **eng._reoptimize_solve_kwargs(cfg, solve_method))
        return states._replace(
            poses=torch.cat([poses_b, states.poses[:, nb:]], dim=1),
            graph=graph,
            pass_number=states.pass_number + 1,
            first_scan_for_pass=torch.ones_like(states.first_scan_for_pass),
            odom_initialized=torch.zeros_like(states.odom_initialized),
            cumulative_dist=torch.zeros_like(states.cumulative_dist),
        )


def process_sessions_multipass(
    cfg: DpgConfig,
    lane_passes: list[list[tuple[np.ndarray, np.ndarray]]],
    solve_bucket: int | None = None,
    solve_method: str | None = None,
    solve_stride: int = 1,
    solve_gn_iterations: int | None = None,
    solve_cg_iterations: int | None = None,
    run_dpg: bool = True,
    device="cuda",
) -> tuple[SlamState, list[list[int]]]:
    """Multi-pass DPG-SLAM over S batched lanes on `device` (the card
    unless the caller names another): the reference's execution model
    (track, then at each pass boundary reoptimize, then track with a DPG
    step per keyframe; dpg_data_runner_main.cc:30-52 + dpg_slam.cc:122-140)
    as one batched keyframe loop a pass (_process_sessions_batched, with
    the lanes' DPG step on pass >= 1 when run_dpg) and
    batched_increment_pass between passes.

    lane_passes: per lane, one (odometry (T, 3), scans (T, B)) stream a
    pass; every lane has the same pass count. The solve arguments are
    process_sessions_batched's; the default bucket covers each pass's
    cumulative keyframes, and the reoptimize solves "dense" up to 1,024
    node slots, "cg" above (the engine's choice). Raises ValueError where a
    lane's cumulative keyframes exceed the node capacity.

    Returns (the stacked SlamState, per-lane per-pass keyframe counts).
    """
    n_passes = {len(p) for p in lane_passes}
    if len(n_passes) != 1:
        raise ValueError(f"all lanes need the same pass count, got {n_passes}")
    P = n_passes.pop()
    S = len(lane_passes)
    reopt_method = "dense" if cfg.capacity.max_nodes <= 1024 else "cg"
    counts: list[list[int]] = [[] for _ in range(S)]
    with profiling.job():
        with profiling.span("batch.schedule"):
            states = _stack_states(cfg, S, device)
        for p in range(P):
            with profiling.span("batch.schedule"):
                steps, pcounts = _packed_steps(cfg, [lane_passes[s][p] for s in range(S)], solve_stride)
                for s in range(S):
                    counts[s].append(pcounts[s])
                    total = sum(counts[s])
                    if total > cfg.capacity.max_nodes:
                        # The batched loop has no per-step capacity gate:
                        # rows past the capacity would overwrite the last
                        # node row.
                        raise ValueError(
                            f"lane {s}: {total} cumulative keyframes exceed node capacity {cfg.capacity.max_nodes}; "
                            "raise CapacityParams.max_nodes or shorten the passes"
                        )
                bucket = _node_bucket(cfg, max(sum(c) for c in counts) + 1) if solve_bucket is None else solve_bucket
                method = solve_method or _solve_choice(cfg, bucket)
                _check_method(method)
                steps = [torch.as_tensor(x, device=device) for x in steps]
            profiling.count("batch.keyframes", sum(pcounts))
            states = _process_sessions_batched(
                cfg, states, *steps, method, bucket, solve_stride, solve_gn_iterations, solve_cg_iterations,
                run_dpg and p >= 1,
            )
            if p < P - 1:
                states = batched_increment_pass(cfg, states, reopt_method)
        return states, counts


# ---------------------------------------------------------------------------
# Online serving
# ---------------------------------------------------------------------------

class BatchedSlamServer:
    """Online multi-stream serving: S concurrent SLAM sessions on one card
    (the JAX package's BatchedSlamServer).

    The offline batched mode precomputes each stream's keyframe schedule;
    a server cannot (scans arrive live). Here the keyframe gate runs on the
    host per lane (keyframe_schedule's recurrence; it reads only odometry),
    and each gated scan is buffered as its lane's pending keyframe. One
    batched device step (_batched_keyframe_step) runs when enough lanes are
    pending (``min_batch_fraction``) or a pending lane has waited
    ``max_wait_calls`` observe() calls: a bounded-delay batcher, latency
    bounded by max_wait, throughput from running each step with as many
    live lanes as possible. A lane that gates again before its buffered
    keyframe ran keeps the newest scan.

    Lanes that are not pending ride along masked, so each lane executes
    its own keyframe schedule whatever the policy. A lane's result does
    not depend on which lanes share its steps (K1's rows do not depend on
    the batch, the lanes solve keeps per-lane masks and factors one lane
    at a time), so in immediate mode (min_batch_fraction near 0) every
    lane equals process_sessions_batched at solve_stride 1 with the same
    bucket and method.

    The tick loop (observe, flush) reads no device value with the lanes
    solve methods: each step's inputs are snapshots of the pending buffers
    in fresh pinned host memory, uploaded without a sync (the next observe
    mutates the buffers while the card may still read the copy). A timing
    of the loop must therefore end in torch.cuda.synchronize().
    num_nodes and trajectory read the card. Each step writes the node rows
    and factor slots of ``states`` in place: a caller who holds an old
    ``states`` sees it change.

    solve_bucket: node slots the solve runs on (default: the node
    capacity). solve_method: "lanes_chol" / "lanes_cg" or "cg" (the
    engine's solve per lane, which reads the host); default
    _solve_choice(config, bucket). The JAX package's vmapped "dense" and
    "dense_cg" raise ValueError.

    Usage:
      srv = BatchedSlamServer(cfg, n_sessions=16)
      for odom, scans in zip(odom_stream, scan_stream):  # (S, 3), (S, B)
          srv.observe(odom, scans)
      srv.flush()
      traj = srv.trajectory(i)
    """

    def __init__(
        self,
        config: DpgConfig,
        n_sessions: int,
        min_batch_fraction: float = 0.5,
        max_wait_calls: int = 8,
        solve_bucket: int | None = None,
        solve_method: str | None = None,
        device="cuda",
    ):
        self.config = config
        self.S = n_sessions
        self.min_batch = max(1, int(np.ceil(min_batch_fraction * n_sessions)))
        self.max_wait = max_wait_calls
        self.device = torch.device(device)
        self.states = _stack_states(config, n_sessions, self.device)
        self.bucket = solve_bucket or config.capacity.max_nodes
        self.method = solve_method or _solve_choice(config, self.bucket)
        _check_method(self.method)
        B = config.scan.num_beams
        # Host gate state per lane (keyframe_schedule's recurrence).
        self._initialized = np.zeros(n_sessions, bool)
        self._first = np.ones(n_sessions, bool)
        self._odom_at_last = np.zeros((n_sessions, 3))
        self._prev_odom = np.zeros((n_sessions, 3))
        self._cum = np.zeros(n_sessions)
        # Pending keyframe buffers.
        self._pend_odom = np.zeros((n_sessions, 3), np.float32)
        self._pend_scan = np.zeros((n_sessions, B), np.float32)
        self._pend = np.zeros(n_sessions, bool)
        self._pend_age = np.zeros(n_sessions, np.int64)
        # Gate distance at buffering time: the distance travelled between a
        # keyframe's buffering tick and its (possibly delayed) execution
        # counts toward the next keyframe's gate, as the offline schedule's
        # immediate reset has it.
        self._pend_cum = np.zeros(n_sessions)
        # Keyframes each lane has executed (its node count, kept on the host).
        self._nodes = np.zeros(n_sessions, np.int64)
        self.steps_executed = 0
        self.keyframes_executed = 0
        # Per step, the ticks each executed keyframe spent buffered.
        self.wait_hist: list = []

    def _gate(self, odom: np.ndarray) -> np.ndarray:
        """Vectorized host keyframe gate update for one (S, 3) odom tick."""
        pg = self.config.pose_graph
        init = self._initialized
        moved = np.hypot(odom[:, 0] - self._prev_odom[:, 0], odom[:, 1] - self._prev_odom[:, 1])
        self._cum = np.where(init, self._cum + moved, self._cum)
        self._odom_at_last = np.where(init[:, None], self._odom_at_last, odom)
        self._initialized = np.ones_like(init)
        self._prev_odom = odom.copy()
        ang = np.abs(np.angle(np.exp(1j * (odom[:, 2] - self._odom_at_last[:, 2]))))
        return self._first | (self._cum > pg.min_dist_between_nodes) | (ang > pg.min_angle_between_nodes)

    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        """A snapshot of a host buffer on the server's device, with no host
        sync: a pinned copy sent asynchronously (the caching host allocator
        keeps the pinned block until the copy has run)."""
        t = torch.from_numpy(buf)
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _execute(self) -> None:
        valid = self._pend.copy()
        if not valid.any():
            return
        full = valid & (self._nodes >= self.config.capacity.max_nodes)
        if full.any():
            raise ValueError(
                f"lanes {np.nonzero(full)[0].tolist()} are at the node capacity "
                f"{self.config.capacity.max_nodes}; raise CapacityParams.max_nodes"
            )
        self.wait_hist.append(self._pend_age[valid].copy())
        with profiling.job():
            self.states = _batched_keyframe_step(
                self.config, self.states, self._upload(self._pend_odom), self._upload(self._pend_scan),
                self._upload(valid), self.method, self.bucket,
            )
        profiling.count("batch.steps")
        profiling.count("batch.lane_steps", self.S)
        profiling.count("batch.keyframes", int(valid.sum()))
        # Keyframe bookkeeping of the executed lanes. _cum rebases to the
        # distance accumulated since the buffered keyframe's tick, so a
        # delayed execution does not drop travel toward the next gate.
        self._first[valid] = False
        self._cum[valid] = np.maximum(self._cum[valid] - self._pend_cum[valid], 0.0)
        self._pend_cum[valid] = 0.0
        self._odom_at_last[valid] = self._pend_odom[valid]
        self._pend[:] = False
        self._pend_age[:] = 0
        self._nodes += valid
        self.steps_executed += 1
        self.keyframes_executed += int(valid.sum())

    def observe(self, odom_batch, scans_batch) -> np.ndarray:
        """One tick of all S streams: (S, 3) absolute odometry and (S, B)
        scans. Returns the (S,) bool mask of lanes whose scan was accepted
        as a new keyframe (buffered; executed now or within max_wait
        calls)."""
        odom = np.asarray(odom_batch, np.float64).reshape(self.S, 3)
        scans = np.asarray(scans_batch, np.float32)
        gate = self._gate(odom)
        newly = gate & ~self._pend
        # A lane gating again before its buffered keyframe executed keeps
        # the newest scan (the buffered one is superseded).
        self._pend_odom[gate] = odom[gate].astype(np.float32)
        self._pend_scan[gate] = scans[gate]
        self._pend_cum[gate] = self._cum[gate]
        self._pend |= gate
        self._pend_age[self._pend] += 1
        if int(self._pend.sum()) >= self.min_batch or (self._pend.any() and int(self._pend_age.max()) >= self.max_wait):
            self._execute()
        return newly

    def flush(self) -> None:
        """Execute any buffered keyframes now."""
        self._execute()

    def num_nodes(self, i: int) -> int:
        return int(self.states.num_nodes[i])

    def trajectory(self, i: int) -> np.ndarray:
        """Lane i's (num_nodes, 3) poses, on the host."""
        return self.states.poses[i, : self.num_nodes(i)].cpu().numpy()
