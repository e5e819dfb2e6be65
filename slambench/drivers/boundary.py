"""The pass boundary alone: every lane's first pass is built once, in the
warm job, with `process_sessions_multipass` over that pass, and every job
re-aligns a fresh copy of it with `batch.batched_increment_pass` (called
through the module, so that the capture and the readers' wrappers see
it). A job's keyframes are those its boundary re-aligns.

The job runs no keyframe step, so no frontend call is copied: the stage
is named only because check.compare reports its numbers in every cell,
and they read 0 over no copied step."""

from __future__ import annotations

from slambench.drivers import multipass

STAGES = ("frontend", "boundary")


def make_inputs(cfg, traffic: dict, seed: int) -> dict:
    """The multipass driver's inputs of the traffic's first pass."""
    return multipass.make_inputs(cfg, dict(traffic, passes=traffic["passes"][:1]), seed)


def stage_calls(cfg, traffic: dict, inputs: dict) -> dict:
    return dict(frontend=[], boundary=1)


def run_job(prog, cfg, traffic: dict, inputs: dict, device: str):
    """One job: the cached first-pass states (built by the first job)
    copied, then one pass boundary. Returns (states, keyframes)."""
    if "first_pass" not in inputs:
        states, counts = prog.process_sessions_multipass(
            cfg, inputs["lane_passes"], solve_stride=traffic["solve_stride"],
            solve_gn_iterations=traffic["solve_gn_iterations"], device=device)
        inputs["first_pass"], inputs["first_pass_keyframes"] = states, sum(sum(c) for c in counts)
    copy = prog.batch._tree_map(lambda x: x.clone(), inputs["first_pass"])
    states = prog.batch.batched_increment_pass(cfg, copy, "dense")
    return states, inputs["first_pass_keyframes"]
