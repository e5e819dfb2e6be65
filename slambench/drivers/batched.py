"""Session-batched tracking: `process_sessions_batched` on every session
of the traffic mix at once, one pass each."""

from __future__ import annotations

from slambench.drivers import common

STAGES = ("frontend", "solve")


def make_inputs(cfg, traffic: dict, seed: int) -> dict:
    ses, _ = common.sessions(cfg, traffic, [tuple(b) for b in traffic["boxes"]],
                             common.seeds(seed, traffic["sessions"]))
    return dict(sessions=ses, lane_passes=[[s] for s in ses])


def stage_calls(cfg, traffic: dict, inputs: dict) -> dict:
    km = common.steps(cfg, inputs["sessions"], traffic["solve_stride"])
    return dict(frontend=km, solve=km // traffic["solve_stride"])


def run_job(prog, cfg, traffic: dict, inputs: dict, device: str):
    """One job: every session from a fresh state. Returns (stacked
    states, keyframes)."""
    states, counts = prog.process_sessions_batched(
        cfg, inputs["sessions"], solve_bucket=traffic["solve_bucket"], solve_method=traffic["solve_method"],
        solve_stride=traffic["solve_stride"], solve_gn_iterations=traffic["solve_gn_iterations"], device=device)
    return states, sum(counts)
