"""What the drivers share: the scan geometry of a configuration, the
simulated sessions of one pass of a traffic mix, and the keyframe steps
the batched loop runs."""

from __future__ import annotations

from slambench import sim
from slambench.reference.frontend import keyframe_cap, keyframe_schedule


def geometry(cfg) -> sim.ScanGeometry:
    s = cfg.scan
    return sim.ScanGeometry(s.num_beams, s.angle_min, s.angle_max, s.range_min, s.range_max)


def sessions(cfg, traffic: dict, boxes, seeds) -> tuple[list, list]:
    """One simulated (odometry, scans) session per seed over the office
    world with `boxes`, `laps` times round its loop, and each session's
    ground truth."""
    seqs = sim.simulate_sessions(sim.office_world(boxes), sim.office_loop_waypoints(traffic["laps"]), geometry(cfg),
                                 seeds, step=traffic["step_m"], odom_noise_transl=traffic["odom_noise_transl"],
                                 odom_noise_rot=traffic["odom_noise_rot"], scan_noise=traffic["scan_noise"])
    return [(q.odometry, q.scans) for q in seqs], [q.ground_truth for q in seqs]


def steps(cfg, sessions_of_pass, stride: int) -> int:
    """Keyframe steps of one pass of the batched loop: the longest
    session's keyframes (capped by the worst-case edge budget), padded to
    a multiple of the solve stride."""
    cap = keyframe_cap(cfg)
    km = max(min(int(keyframe_schedule(cfg.pose_graph, odo).sum()), cap) for odo, _ in sessions_of_pass)
    return -(-km // stride) * stride


def seeds(seed: int, n: int, pass_index: int = 0) -> list:
    """Each session's seed, derived from the run's: the seed sequence
    [seed, pass, session]."""
    return [[seed, pass_index, i] for i in range(n)]


__all__ = ["geometry", "keyframe_schedule", "seeds", "sessions", "steps"]
