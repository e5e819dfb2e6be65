"""Long-term mapping in the GDC session structure on the port's normal
path: process_sessions_multipass over two lanes of four passes (the gdc
suite's boxes: one at (2, 1.5) in pass 0, none in passes 1-2, one at
(-3, 1.5) in pass 3) at a small CPU size of the benchmark's
configuration office-gdc4, against the benchmark's plain reference
(slambench/reference), which imports nothing of the port:

  - the pass boundaries that follow a DPG pass (on graphs that DPG has
    pruned) against reference.reopt.increment_pass from the program's
    state at entry: the rebuilt factor rows equal, the re-aligned poses'
    edge-relative gaps within BOUNDARY_TOL;
  - pass-3 DPG steps (the map of three earlier passes) against
    reference.dpg.execute on the same state: labels, sector and node
    activity equal;
  - the boundary's counters boundary.sweep_pairs / boundary.sweep_slots
    against the host compaction of the state at entry;
  - the benchmark's boundary driver: two jobs from one cached first pass
    give the same poses to the bit and leave the cache as it was.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from dpg_slam_tpu_torch import batch, engine
from dpg_slam_tpu_torch.config import DpgConfig
from dpg_slam_tpu_torch.utils import profiling
from slambench import capture, check, reference
from slambench.drivers import boundary, multipass
from slambench.reference import dpg as ref_dpg, geom, reopt as ref_reopt

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAFFIC = dict(lanes=2, laps=1, step_m=0.25, odom_noise_transl=0.02, odom_noise_rot=0.008, scan_noise=0.01,
               solve_stride=4, solve_gn_iterations=5, dpg_check_region=dict(y_min=1.0),
               passes=[dict(boxes=[[2.0, 1.5, 1.0, 1.0]]), dict(boxes=[]), dict(boxes=[]),
                       dict(boxes=[[-3.0, 1.5, 1.0, 1.0]])])
SEED = 2419
# Edge-relative pose gap (m / rad) of a boundary against the reference's:
# the cell's lane bound (check.LANE_OFF_M). Both run in float32 with other
# summation orders (the reference's LM assembles a dense system); here they
# agree to 2.1e-5 or better, while a boundary that keeps its poses reads
# 0.17-0.40 after a DPG pass.
BOUNDARY_TOL = check.LANE_OFF_M["boundary"]


def _small(doc: dict) -> dict:
    """office-gdc4 at a CPU size: 128 beams, 32 ICP points, 2 closures, a
    128-cell DPG window with M = 4; 256 node slots hold the four passes."""
    c = doc["config"]
    c["scan"]["num_beams"] = 128
    c["pose_graph"].update(icp_max_points=32, icp_maximum_iterations=10, max_loop_closures_per_node=2)
    c["capacity"].update(max_nodes=256, max_edges=1024, max_priors=4)
    c["dpg"].update(max_submap_nodes=4, grid_extent_cells=128, local_reg_max_points=256)
    return c


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    doc = _small(json.loads((ROOT / "slambench" / "configs" / "office-gdc4.json").read_text()))
    cfg, cfg_ref = DpgConfig.from_dict(doc), reference.config(doc)
    inputs = multipass.make_inputs(cfg_ref, TRAFFIC, SEED)
    return cfg, cfg_ref, inputs


@pytest.fixture(scope="module")
def run4(setup):
    """One four-pass job with its boundaries and the first two pass-3 DPG
    steps with the moved box in view copied (slambench.capture), and each
    boundary's counters beside the host compaction of its entry state."""
    cfg, cfg_ref, inputs = setup
    dpg_calls = multipass.stage_calls(cfg_ref, TRAFFIC, inputs)["dpg"][:2]
    cap = capture.Capture(dict(boundary=[0, 1, 2], dpg=dpg_calls)).install()
    sweeps = []
    orig = batch.batched_increment_pass

    def counted(cfg, states, *a, **k):
        nn = states.num_nodes.cpu().numpy()
        nb = batch._node_bucket(cfg, int(nn.max()))
        live = [engine._reoptimize_compaction_host(cfg, states.poses[s, :nb].numpy(), states.pass_ids[s, :nb].numpy(),
                                                   int(nn[s]), nb)
                for s in range(len(nn))]
        before = profiling.counters()
        out = orig(cfg, states, *a, **k)
        after = profiling.counters()
        sweeps.append(dict(live=sum(n for _, _, n in live), slots=len(nn) * max(idx.shape[0] for idx, _, _ in live),
                           counted={n: after.get(n, 0) - before.get(n, 0)
                                    for n in ("boundary.sweep_pairs", "boundary.sweep_slots")},
                           graph=out.graph))
        return out

    batch.batched_increment_pass = counted
    try:
        states, counts = batch.process_sessions_multipass(
            cfg, inputs["lane_passes"], solve_stride=TRAFFIC["solve_stride"],
            solve_gn_iterations=TRAFFIC["solve_gn_iterations"], device="cpu")
    finally:
        batch.batched_increment_pass = orig
        cap.remove()
    return states, counts, cap.items, sweeps


def test_four_passes_on_every_lane(setup, run4):
    _, cfg_ref, inputs = setup
    states, counts, items, sweeps = run4
    assert [len(c) for c in counts] == [4, 4]
    assert np.array_equal(states.num_nodes.numpy(), check.expected_counts(cfg_ref, inputs["lane_passes"]))
    assert states.pass_number.tolist() == [3, 3]
    assert len(items["boundary"]) == 3 and len(sweeps) == 3


@pytest.mark.parametrize("call", [1, 2])
def test_boundary_after_a_dpg_pass_matches_the_reference(setup, run4, call):
    """The boundary after pass `call`, which ran DPG: its entry state holds
    nodes DPG deactivated."""
    _, cfg_ref, _ = setup
    item = run4[2]["boundary"][call]
    inp = item["inp"]
    live = torch.arange(inp["poses"].shape[1]) < inp["num_nodes"][:, None]
    assert (inp["pass_ids"][live].amax() == call) and (~inp["node_active"] & live).any()
    poses, graph = ref_reopt.increment_pass(cfg_ref, inp)
    prog = run4[3][call]["graph"]
    assert torch.equal(prog.num_priors, graph["num_priors"]) and torch.equal(prog.num_edges, graph["num_edges"])
    for s, n in enumerate(graph["num_edges"].tolist()):
        assert torch.equal(prog.prior_idx[s, :int(graph["num_priors"][s])], graph["prior_idx"][s, :int(graph["num_priors"][s])])
        assert torch.equal(prog.edge_idx[s, :n], graph["edge_idx"][s, :n])
    gaps = check._edge_gaps(item["poses"], poses, graph)
    assert float(gaps.max()) <= BOUNDARY_TOL, gaps


def test_pass3_dpg_steps_match_the_reference(setup, run4):
    """DPG on pass 3 against the map of passes 0-2: every live entry of
    labels, sector_active and node_active equal."""
    _, cfg_ref, _ = setup
    items = run4[2]["dpg"]
    assert len(items) == 2
    for it in items:
        assert it["inp"]["pass_number"].tolist() == [3, 3]
        ref = ref_dpg.execute(cfg_ref, it["inp"], geom.exact)
        live = torch.arange(it["inp"]["poses"].shape[1]) < it["inp"]["num_nodes"][:, None]
        for f in ("labels", "sector_active", "node_active"):
            assert torch.equal(it["out"][f][live], ref[f][live]), f


def test_boundary_counters_are_the_compactions(run4):
    for s in run4[3]:
        assert s["counted"] == {"boundary.sweep_pairs": s["live"], "boundary.sweep_slots": s["slots"]}
        assert 0 < s["live"] <= s["slots"]


def test_boundary_jobs_repeat_to_the_bit(setup):
    """The boundary32 driver: the first job builds and caches the first
    pass and re-aligns a copy of it; a second job re-aligns another copy
    to the same bits, and the cache is left as it was."""
    import dpg_slam_tpu_torch as prog

    cfg, cfg_ref, _ = setup
    traffic = dict(TRAFFIC, passes=TRAFFIC["passes"][:1])
    inputs = boundary.make_inputs(cfg_ref, traffic, SEED)
    first, kf = boundary.run_job(prog, cfg, traffic, inputs, "cpu")
    cached = batch._leaves(inputs["first_pass"])
    kept = [x.clone() for x in cached]
    second, kf2 = boundary.run_job(prog, cfg, traffic, inputs, "cpu")
    assert kf == kf2 == int(inputs["first_pass"].num_nodes.sum())
    assert torch.equal(first.poses, second.poses) and torch.equal(first.graph.edge_meas, second.graph.edge_meas)
    assert not torch.equal(first.poses, inputs["first_pass"].poses)
    assert all(a is b for a, b in zip(batch._leaves(inputs["first_pass"]), cached))
    assert all(torch.equal(a, b) for a, b in zip(cached, kept))
