#!/usr/bin/env python3
"""Where the card's time goes on the PyTorch port's paths (one NVIDIA GPU).

    python3 tools/profile_torch_paths.py [path ...]

Runs each path of chip_smoke.py once to warm up, once under torch.profiler
(CPU + CUDA activity) and once unprofiled, on the committed fixtures:
keyframe (bench_assets/keyframe continuation, solve_method "dense" and
"dense_pallas"), offline (process_sequence over the same scans),
reoptimize (bench_assets/session increment_pass, "dense" and
"dense_pallas"), the 4-shard Schur reoptimize through K2, the
session-batched mode at chip_smoke.py phase 9's configuration (16
simulated sessions of 3 office laps), one DPG step on bench_assets/session,
phase 10d's process_sequence with DPG, the multipass batched mode at
chip_smoke.py phase 11's configuration of record (8 lanes x 2 passes) and
one lane-axis DPG step on the 8 lanes at the end of that run, the pass
boundary of those 8 lanes at the end of pass 0 (batched_increment_pass
with "dense" and "dense_pallas", beside the 8 engine reoptimizes), and the
online server at chip_smoke.py phase 12's configuration (phase 9's
sessions, 300 ticks, policy (0.5, 8)), and the experiment runner of
chip_smoke.py phase 13 (run.run at its default config: the gdc suite
offline, the b21 fixture online and offline, and offline again with 64
node slots in place of 512). Paths named on the command line run alone. Prints one JSON line per path: unprofiled wall ms, device busy
ms (sum of CUDA kernel and memcpy intervals), idle share of the unprofiled
wall, kernel launches (and per keyframe on the keyframe paths, per step on
the batched and server paths), the top kernels by device time (name,
ms, launches), the device ms and launches of K1 and K2, and K1's share of
the busy time. The first line is the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import functools
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

@functools.cache
def batched_inputs():
    cfg = cs.batched_config()
    return cfg, cs.batched_sessions(cfg, cs.BATCH_SESSIONS, cs.BATCH_LAPS)[0]


def run_batched():
    cfg, sessions = batched_inputs()
    return cs.run_batched(cfg, sessions, solve_method=cs.BATCH_METHOD, solve_stride=cs.BATCH_STRIDE,
                          solve_gn_iterations=cs.BATCH_GN)


@functools.cache
def dpg_inputs():
    cfg = cs.session_config()
    seq = cs.dataset.simulate_sequence(cs.dataset.make_office_world(), cs.dataset.office_loop_waypoints(), cfg.scan,
                                       step=0.5, seed=9, odom_noise_transl=0.02, odom_noise_rot=0.008)
    state = cs.load_checkpoint(cs.ASSETS / "session", cs.DEVICE).state
    return cfg, state, seq.odometry[: cs.DPG_OFFLINE_SCANS], seq.scans[: cs.DPG_OFFLINE_SCANS]


def run_dpg_step():
    cfg, state, _, _ = dpg_inputs()
    return cs.dpg_step(cfg, state)


@functools.cache
def multipass_inputs():
    cfg = cs.multipass_config()
    return cfg, cs.multipass_lanes(cfg)[0]


def run_multipass():
    return cs.run_multipass(*multipass_inputs())


@functools.cache
def lane_dpg_state():
    cfg, _ = multipass_inputs()
    return cfg, run_multipass()[0]


@functools.cache
def pass0_states():
    """The multipass configuration of record's stacked states at the end
    of pass 0 (chip_smoke.py phase 11e's input)."""
    cfg, lanes = multipass_inputs()
    states, _ = cs.batch_mod.process_sessions_multipass(cfg, [passes[:1] for passes in lanes],
                                                        solve_stride=cs.MULTI_STRIDE,
                                                        solve_gn_iterations=cs.MULTI_GN, device=cs.DEVICE)
    return cfg, states


def run_increment_pass(method: str = "dense"):
    """batched_increment_pass on every lane at once (one K1 sweep, one
    lane-axis LM), ending in a sync."""
    cfg, states = pass0_states()
    out = cs.batch_mod.batched_increment_pass(cfg, cs.clone_states(states), method)
    torch.cuda.synchronize()
    return out


def run_engine_reoptimizes():
    """The same pass boundary as 8 engine reoptimizes, one a lane."""
    cfg, states = pass0_states()
    engines = []
    for i in range(states.poses.shape[0]):
        eng = cs.eng_mod.DpgSlamEngine(cfg, cs.DEVICE)
        eng.state = cs.batch_mod.session_state(states, i)
        eng.increment_pass()
        engines.append(eng)
    torch.cuda.synchronize()
    return engines


def run_server():
    """The server over phase 12's ticks at its quality policy, ending in
    a sync; returns the server."""
    cfg, sessions = batched_inputs()
    odo, scn = cs.server_streams(sessions)
    srv = cs.make_server(cfg, odo.shape[1], *cs.SERVER_QUALITY_POLICY)
    cs.tick_loop(srv, odo, scn)
    torch.cuda.synchronize()
    return srv


def run_lane_dpg_step():
    out = cs.change_detection.execute_dpg_lanes(*lane_dpg_state())
    torch.cuda.synchronize()
    return out


def run_runner(*flags):
    """dpg_slam_tpu_torch.run on the card; returns (summary, engine)."""
    out = cs.run_mod.run(cs.run_mod.parse_args(list(flags)))
    torch.cuda.synchronize()
    return out


PATHS = {
    "keyframe_dense": lambda: cs.run_keyframes(cs.DEVICE),
    "keyframe_dense_pallas": lambda: cs.run_keyframes(cs.DEVICE, "dense_pallas"),
    "offline_dense": lambda: cs.run_offline(),
    "offline_pipelined_dense": lambda: cs.run_offline(pipelined=True),
    "batched_record": run_batched,
    "reoptimize_dense": lambda: cs.run_reoptimize(cs.DEVICE),
    "reoptimize_dense_pallas": lambda: cs.run_reoptimize(cs.DEVICE, "dense_pallas"),
    "schur_4_shards_k2": lambda: cs.session_schur(True),
    "dpg_step": run_dpg_step,
    "offline_dpg": lambda: cs.run_dpg_offline(*dpg_inputs(), True),
    "multipass_record": run_multipass,
    "dpg_step_8_lanes": run_lane_dpg_step,
    "increment_pass_8_lanes": run_increment_pass,
    "increment_pass_8_lanes_dense_pallas": lambda: run_increment_pass("dense_pallas"),
    "engine_reoptimize_8_lanes": run_engine_reoptimizes,
    "server_record": run_server,
    "runner_gdc_offline": lambda: run_runner("--suite", "gdc", "--offline"),
    "runner_b21_online": lambda: run_runner("--suite", str(cs.B21_SUITE)),
    "runner_b21_offline": lambda: run_runner("--suite", str(cs.B21_SUITE), "--offline"),
    "runner_b21_offline_64_nodes": lambda: run_runner("--suite", str(cs.B21_SUITE), "--offline", "--max-nodes", "64"),
}

# The port's hand-written kernels, by the names of their CUDA kernels.
KERNELS = {"K1": ("icp_p2l_kernel",), "K2": ("spd_solve_kernel", "chol_panel_kernel", "chol_trailing_kernel")}


def timed(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_paths.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name in sys.argv[1:] or PATHS:
        run = PATHS[name]
        out = run()
        keyframes = {"keyframe": lambda: len(out[1]), "offline": lambda: int(out[1].sum()),
                     "batched": lambda: sum(out[1]), "multipass": lambda: sum(map(sum, out[1])),
                     "server": lambda: out.keyframes_executed,
                     "runner": lambda: sum(p["keyframes"] for p in out[0]["passes"])}
        kf = next((f() for k, f in keyframes.items() if name.startswith(k)), None)
        steps = {"batched": lambda: -(-max(out[1]) // cs.BATCH_STRIDE) * cs.BATCH_STRIDE,
                 "server": lambda: out.steps_executed}
        n_steps = next((f() for k, f in steps.items() if name.startswith(k)), None)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = timed(run)
        by_name = defaultdict(float)
        count = defaultdict(int)
        launches = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us() / 1e3
                count[e.name] += 1
                launches += 1
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ours = {k: [sum(v for n, v in by_name.items() if any(m in n for m in marks)),
                    sum(c for n, c in count.items() if any(m in n for m in marks))]
                for k, marks in KERNELS.items()}
        print(json.dumps({
            "path": name, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "device_ops": launches, "keyframes": kf,
            "device_ops_per_keyframe": launches / kf if kf else None, "steps": n_steps,
            "device_ops_per_step": launches / n_steps if n_steps else None,
            "top": [[k[:60], v, count[k]] for k, v in top],
            "kernels_ms_launches": ours, "k1_share": ours["K1"][0] / busy if busy else None,
        }), flush=True)


if __name__ == "__main__":
    main()
