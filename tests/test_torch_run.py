"""The port's experiment runner (dpg_slam_tpu_torch.run) against the JAX
package's (dpg_slam_tpu.run) on the same arguments, on the CPU, online: two
passes of the box_change scenario at 128 beams, with keyframes per pass
equal, per-pass ATE within 5e-3 m and map-layer counts within max(2, 3 %)
(ROADMAP Queue 3 item 4's tolerance: labels drift with the poses, which
sum in another order). Also its output files: checkpoints loading in both
directions, the --profile stages and trace, the --render PNG; and the
refusal to run without a card when --device is left at cuda.
tests/test_torch_run_offline.py holds --offline, the --save-logs /
--logs replay and the engine-level robustness cases."""

import json

import numpy as np
import pytest
import torch

from dpg_slam_tpu import run as jrun
from dpg_slam_tpu.utils import checkpoint as jcheckpoint
from dpg_slam_tpu.utils import profiling as jprofiling
from dpg_slam_tpu_torch import run, viz
from dpg_slam_tpu_torch.utils import checkpoint
from dpg_slam_tpu_torch.utils.profiling import TRACE_FILE

ARGS = ["--num-beams", "128", "--max-nodes", "128", "--passes", "2", "--scenario", "box_change"]
ATE_TOL = 5e-3
LAYER_ABS, LAYER_REL = 2, 0.03


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many tiny CPU ops (as
    tests/test_torch_batch.py); restored for the worker's later modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_runners(tmp_path_factory, name, extra, port_extra=()):
    """Both runners on ARGS + extra (the port's also on port_extra), each
    into its own --out; returns (port summary, port engine, port out, JAX out)."""
    port_out = tmp_path_factory.mktemp(f"port_{name}")
    jax_out = tmp_path_factory.mktemp(f"jax_{name}")
    port_summary, eng = run.run(run.parse_args([*ARGS, *extra, *port_extra, "--device", "cpu",
                                                "--out", str(port_out)]))
    assert jrun.main([*ARGS, *extra, "--out", str(jax_out)]) == 0
    return port_summary, eng, port_out, jax_out


def assert_runner_matches_jax(port_out, jax_out, extra_keys=()):
    port = json.loads((port_out / "summary.json").read_text())
    want = json.loads((jax_out / "summary.json").read_text())
    assert set(port) == set(want) | {"device", *extra_keys} and port["device"] == {"type": "cpu", "name": "cpu"}
    assert len(port["passes"]) == len(want["passes"]) == 2
    for p, w in zip(port["passes"], want["passes"]):
        assert set(p) == set(w)
        assert p["keyframes"] == w["keyframes"] > 20
        assert abs(p["ate_m"] - w["ate_m"]) <= ATE_TOL, (p, w)
    assert port["total_nodes"] == want["total_nodes"]
    assert set(port["map_layers"]) == set(want["map_layers"])
    for k, n in want["map_layers"].items():
        assert abs(port["map_layers"][k] - n) <= max(LAYER_ABS, LAYER_REL * n), (k, port["map_layers"], n)
    assert port["map_layers"]["dynamic_added"] > 0 and port["map_layers"]["dynamic_removed"] > 0
    traj = np.load(port_out / "trajectory.npz")
    assert traj["poses"].shape == traj["odometry"].shape == (port["total_nodes"], 3)


@pytest.fixture(scope="module")
def online(tmp_path_factory):
    return both_runners(tmp_path_factory, "online", ["--save-checkpoint"],
                        port_extra=["--render", "--profile"])


def test_runner_matches_jax_online(online):
    _, _, port_out, jax_out = online
    assert_runner_matches_jax(port_out, jax_out, extra_keys=("profile",))


def test_main_prints_the_summary(tmp_path, capsys):
    assert run.main(["--num-beams", "128", "--max-nodes", "64", "--passes", "1", "--scenario", "static",
                     "--device", "cpu", "--out", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads((tmp_path / "summary.json").read_text())
    assert printed["passes"][0]["keyframes"] > 5


def test_checkpoints_load_both_ways(online):
    _, eng, port_out, jax_out = online
    with np.load(port_out / "checkpoint" / "state.npz") as p, np.load(jax_out / "checkpoint" / "state.npz") as j:
        assert set(p.files) == set(j.files)
        for k in j.files:
            assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
    assert (port_out / "checkpoint" / "config.json").read_text() == (jax_out / "checkpoint" / "config.json").read_text()
    # The JAX package loads the port's checkpoint, and the port the JAX package's.
    np.testing.assert_array_equal(jcheckpoint.load_checkpoint(port_out / "checkpoint").trajectory(),
                                  eng.trajectory())
    jax_traj = np.load(jax_out / "trajectory.npz")["poses"]
    back = checkpoint.load_checkpoint(jax_out / "checkpoint", device="cpu")
    np.testing.assert_array_equal(back.trajectory(), jax_traj)
    for key, arr in checkpoint.state_to_numpy(eng.state).items():
        assert np.array_equal(checkpoint.state_to_numpy(
            checkpoint.load_checkpoint(port_out / "checkpoint", device="cpu").state)[key], arr), key


def test_profile_stages_and_trace(online):
    """The JAX runner's stages, in the JAX StageTimer's summary schema, and
    the program's spans in the trace."""
    summary, _, port_out, _ = online
    jax_timer = jprofiling.StageTimer()
    with jax_timer("stage"):
        pass
    scans = sum(p["scans"] for p in summary["passes"])
    assert {k: v["count"] for k, v in summary["profile"].items()} == {
        "observe_odometry": scans, "observe_laser": scans, "reoptimize": 1}
    for v in summary["profile"].values():
        assert set(v) == set(jax_timer.summary()["stage"]) and v["total_s"] > 0
    trace = json.loads((port_out / "trace" / TRACE_FILE).read_text())
    assert len(trace["traceEvents"]) > 100
    # --profile records the program's spans: the reoptimize's ICP sweep
    # is a range of the trace.
    assert "icp.align" in {e.get("name") for e in trace["traceEvents"]}


def test_render_png(online):
    summary, eng, port_out, _ = online
    assert summary["render"] == str(port_out / "map.png")
    assert (port_out / "map.png").stat().st_size > 10_000
    drawn = viz.draw_session(eng).to_dict()
    assert len(drawn["points"]) > 1000 and len(drawn["lines"]) == 2 * eng.num_nodes()


def test_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--num-beams", "128", "--passes", "1"])
