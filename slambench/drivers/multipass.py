"""Multi-pass long-term mapping: `process_sessions_multipass` on every
lane of the traffic mix, one session a pass per lane, with DPG change
detection on every keyframe step after the first pass and the pass
boundary between passes."""

from __future__ import annotations

from slambench.drivers import common

STAGES = ("frontend", "solve", "dpg", "boundary")


def make_inputs(cfg, traffic: dict, seed: int) -> dict:
    n = traffic["lanes"]
    made = [common.sessions(cfg, traffic, [tuple(b) for b in p["boxes"]], common.seeds(seed, n, i))
            for i, p in enumerate(traffic["passes"])]
    P = len(made)
    return dict(lane_passes=[[made[p][0][i] for p in range(P)] for i in range(n)],
                ground_truth=[[made[p][1][i] for p in range(P)] for i in range(n)])


def stage_calls(cfg, traffic: dict, inputs: dict) -> dict:
    """Calls of each stage in a job. The frontend's are those of the last
    pass, whose edges the final graph keeps (the pass boundary rebuilds
    the earlier ones); the DPG step's, the steps of the last pass whose
    keyframe (lane 0's, on its ground truth) lies in the traffic's check
    region, where the moved boxes are in view."""
    stride = traffic["solve_stride"]
    P = len(traffic["passes"])
    km = [common.steps(cfg, [lane[p] for lane in inputs["lane_passes"]], stride) for p in range(P)]
    odo, _ = inputs["lane_passes"][0][P - 1]
    gt = inputs["ground_truth"][0][P - 1][common.keyframe_schedule(cfg.pose_graph, odo)]
    y_min = traffic["dpg_check_region"]["y_min"]
    return dict(frontend=list(range(sum(km[:P - 1]), sum(km))), solve=sum(km) // stride, boundary=P - 1,
                dpg=[sum(km[1:P - 1]) + k for k in range(len(gt)) if gt[k, 1] >= y_min])


def run_job(prog, cfg, traffic: dict, inputs: dict, device: str):
    """One job: every lane's passes from a fresh state. Returns (stacked
    states, keyframes)."""
    states, counts = prog.process_sessions_multipass(
        cfg, inputs["lane_passes"], solve_stride=traffic["solve_stride"],
        solve_gn_iterations=traffic["solve_gn_iterations"], device=device)
    return states, sum(sum(c) for c in counts)
