"""The recorder of dpg_slam_tpu_torch/utils/profiling.py: spans and
counters.

Off (the default) a span is one shared null context that records nothing
and calls no torch API; inside tracing() it records (name, start, end,
parent, job) and opens a torch.profiler range of its name. Counters
always count, and only host-known numbers. Here, on the CPU at a tiny
size: a hand-built span tree with a fake clock; a two-lane batched run
and a two-lane, two-pass multipass run (DPG on pass 1, one pass
boundary) bit-identical with tracing on and off; their counters against
the values the host knows; the spans as profiler ranges that enclose
their stage's ops; and every span name the package opens listed in SPANS.
"""

import ast
import bisect
import pathlib

import pytest
import torch

from dpg_slam_tpu_torch import batch
from dpg_slam_tpu_torch.config import CapacityParams, DpgConfig, DpgParams, PoseGraphParams, ScanParams
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.ops import icp
from dpg_slam_tpu_torch.utils import profiling

PKG = pathlib.Path(profiling.__file__).resolve().parents[1]
SCANS = 48  # scans of each simulated session (~12 keyframes at 1 m)
STRIDE = 4
GN_ITERATIONS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the many tiny CPU ops (as in
    tests/test_torch_batch.py); restored for the worker's later modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config() -> DpgConfig:
    return DpgConfig(
        scan=ScanParams(num_beams=128),
        pose_graph=PoseGraphParams(icp_max_points=32, icp_maximum_iterations=10, max_loop_closures_per_node=2),
        dpg=DpgParams(grid_extent_cells=128, occ_grid_resolution=0.1, max_submap_nodes=4, local_reg_max_points=256),
        capacity=CapacityParams(max_nodes=64, max_edges=256, max_priors=4),
    )


def _session(cfg: DpgConfig, seed: int, box=None):
    world = dataset.make_office_world()
    if box is not None:
        world = world.add_box(*box)
    seq = dataset.simulate_sequence(world, dataset.office_loop_waypoints(), cfg.scan, step=0.25, seed=seed,
                                    odom_noise_transl=0.02, odom_noise_rot=0.008)
    return seq.odometry[:SCANS], seq.scans[:SCANS]


@pytest.fixture(scope="module")
def cfg():
    return _config()


@pytest.fixture(scope="module")
def sessions(cfg):
    return [_session(cfg, seed) for seed in (1, 2)]


@pytest.fixture(scope="module")
def lane_passes(cfg):
    return [[_session(cfg, 10 * lane + p, box) for p, box in enumerate(((2.0, 1.5, 1.0, 1.0), (-3.0, 1.5, 1.0, 1.0)))]
            for lane in range(2)]


def _batched(cfg, sessions):
    return batch.process_sessions_batched(cfg, sessions, solve_method="lanes_chol", solve_stride=STRIDE,
                                          solve_gn_iterations=GN_ITERATIONS, device="cpu")


def _multipass(cfg, lane_passes):
    return batch.process_sessions_multipass(cfg, lane_passes, solve_stride=STRIDE, solve_gn_iterations=GN_ITERATIONS,
                                            device="cpu")


RUNS = {"batched": lambda cfg, s, lp: _batched(cfg, s), "multipass": lambda cfg, s, lp: _multipass(cfg, lp)}


class _Clock:
    """time.perf_counter_ns that steps 1 ms a read."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        self.ns += 1_000_000
        return self.ns


def _leaves(state):
    return [x for f in state for x in (_leaves(f) if hasattr(f, "_fields") else [f])]


def _assert_bit_identical(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_off_records_nothing_and_calls_no_torch_api(monkeypatch):
    def no_torch(*a, **k):
        raise AssertionError("a span called torch while tracing was off")

    monkeypatch.setattr(torch.profiler, "record_function", no_torch)
    assert profiling.span("batch.loop") is profiling.span("icp.align") is profiling.job()
    with profiling.job(), profiling.span("batch.loop"), profiling.span("icp.align"):
        pass
    monkeypatch.undo()
    with profiling.tracing() as rec:
        pass
    assert rec.spans == [] and rec.summary() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("batch.loop"):
            torch.ones(4).add_(1.0)
    names = {e.name for e in prof.events()}
    assert "aten::add_" in names and "batch.loop" not in names


def test_tree_parents_jobs_and_self_time(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock())
    with profiling.tracing() as outer:
        with profiling.job():
            with profiling.span("batch.loop"):                  # 1 .. 8 ms
                with profiling.tracing() as inner:
                    with profiling.span("batch.keyframe"):      # 2 .. 5
                        with profiling.span("icp.align"):       # 3 .. 4
                            pass
                with profiling.span("batch.solve"):             # 6 .. 7
                    with profiling.job():                       # joins the open job
                        pass
        with profiling.span("batch.boundary"):                  # 9 .. 10, a job of its own
            pass
        live = len(outer.spans)
    got = {s.name: s for s in outer.spans}
    assert [s.name for s in outer.spans] == ["icp.align", "batch.keyframe", "batch.solve", "batch.loop",
                                             "batch.boundary"] and live == 5
    assert [s.name for s in inner.spans] == ["icp.align", "batch.keyframe"]
    assert got["icp.align"].parent == got["batch.keyframe"].id
    assert got["batch.keyframe"].parent == got["batch.solve"].parent == got["batch.loop"].id
    assert got["batch.loop"].parent is None and got["batch.boundary"].parent is None
    assert len({got[n].job for n in ("icp.align", "batch.keyframe", "batch.solve", "batch.loop")}) == 1
    assert got["batch.boundary"].job != got["batch.loop"].job
    assert (got["batch.loop"].start_ns, got["batch.loop"].end_ns) == (1_000_000, 8_000_000)
    summary = outer.summary()
    assert summary["batch.loop"] == dict(count=1, total_ms=7.0, self_ms=3.0)
    assert summary["batch.keyframe"] == dict(count=1, total_ms=3.0, self_ms=2.0)
    assert summary["icp.align"] == summary["batch.solve"] == summary["batch.boundary"] == dict(
        count=1, total_ms=1.0, self_ms=1.0)
    assert profiling.summary(inner.spans)["batch.keyframe"]["self_ms"] == 2.0
    with profiling.tracing() as again:
        pass
    assert again.spans == []  # the outermost block's close clears the recorder


def test_counters_count_and_copy():
    before = profiling.counters()
    profiling.count("k1.pairs", 7)
    profiling.count("k1.pairs")
    got = profiling.counters()
    assert got["k1.pairs"] == before.get("k1.pairs", 0) + 8
    got["k1.pairs"] = -1
    assert profiling.counters()["k1.pairs"] != -1
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_runs_bit_identical_with_tracing_on_and_off(cfg, sessions, lane_passes, run):
    off, counts_off = RUNS[run](cfg, sessions, lane_passes)
    with profiling.tracing() as rec:
        on, counts_on = RUNS[run](cfg, sessions, lane_passes)
    assert counts_on == counts_off
    _assert_bit_identical(off, on)
    summary = rec.summary()
    assert summary["batch.keyframe"]["count"] > 0 and summary["batch.solve"]["count"] > 0
    assert len({s.job for s in rec.spans}) == 1  # one top-level call, one job
    assert set(summary) <= set(profiling.SPANS)
    for name, s in summary.items():
        assert s["total_ms"] >= s["self_ms"] >= 0.0, name


def test_batched_counters_equal_the_host_known_values(cfg, sessions):
    kf_odom, _, _, counts = batch.pack_sessions(cfg, sessions)
    steps = -(-kf_odom.shape[0] // STRIDE) * STRIDE
    S, K1 = len(sessions), 1 + cfg.pose_graph.max_loop_closures_per_node
    profiling.reset_counters()
    _, got_counts = _batched(cfg, sessions)
    got = profiling.counters()
    assert got_counts == counts
    solves = steps // STRIDE
    assert got == {
        "batch.keyframes": sum(counts), "batch.steps": steps, "batch.lane_steps": steps * S,
        "k1.pairs": steps * S * K1, "graph.lm_iterations": solves * GN_ITERATIONS,
        "graph.factorizations": solves * GN_ITERATIONS * S,
    }  # no K1 on the CPU, and no host read in the batched loop


def test_multipass_counters_equal_the_host_known_values(cfg, lane_passes, monkeypatch):
    pairs, solves = [], []
    align, dense = icp.icp_align, fg._dense_solve_lanes

    def counted_align(src, *a, **k):
        pairs.append(src.shape[0])
        return align(src, *a, **k)

    def counted_dense(*a, lanes=None, **k):
        solves.append((lanes is not None, len(lanes) if lanes is not None else a[0].diag.shape[0]))
        return dense(*a, lanes=lanes, **k)

    monkeypatch.setattr(icp, "icp_align", counted_align)
    monkeypatch.setattr(fg, "_dense_solve_lanes", counted_dense)
    profiling.reset_counters()
    _, counts = _multipass(cfg, lane_passes)
    got = profiling.counters()
    S = len(lane_passes)
    steps = [-(-max(c[p] for c in counts) // STRIDE) * STRIDE for p in range(2)]
    assert got["batch.keyframes"] == sum(map(sum, counts))
    assert got["batch.steps"] == sum(steps) and got["batch.lane_steps"] == sum(steps) * S
    assert got["k1.pairs"] == sum(pairs) and len(pairs) == sum(steps) + steps[1] + 1  # frontend, DPG, sweep
    assert got["graph.lm_iterations"] == len(solves)
    assert got["graph.factorizations"] == sum(n for _, n in solves)
    boundary_its = sum(at_boundary for at_boundary, _ in solves)
    assert 0 < boundary_its and 3 + boundary_its <= got["host.reads"] <= 3 + boundary_its + 1 + S


def _ranges(prof, names):
    """{name: [(start_ns, end_ns)]} of the profiler's CPU ranges, and the
    sorted (start_ns, end_ns) of its aten ops."""
    ranges, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        span = (start, start + e.duration_ns())
        if e.name() in names:
            ranges.setdefault(e.name(), []).append(span)
        elif e.name().startswith("aten::"):
            ops.append(span)
    ops.sort()
    return ranges, ops


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_are_profiler_ranges_around_their_ops(cfg, sessions, lane_passes, run):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with profiling.tracing() as rec, torch.profiler.profile(activities=acts) as prof:
        RUNS[run](cfg, sessions, lane_passes)
    summary = rec.summary()
    ranges, ops = _ranges(prof, set(profiling.SPANS))
    assert {n: len(r) for n, r in ranges.items()} == {n: s["count"] for n, s in summary.items()}
    starts = [s for s, _ in ops]
    for name, spans in ranges.items():
        for start, end in spans:
            i = bisect.bisect_left(starts, start)
            assert i < len(ops) and ops[i][1] <= end, f"{name}: no op inside the range"
    with torch.profiler.profile(activities=acts) as prof:
        RUNS[run](cfg, sessions, lane_passes)
    assert _ranges(prof, set(profiling.SPANS))[0] == {}


def _literal_calls(tree, names):
    """The string literals passed first to calls of `names` (as a name or
    an attribute)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            f = node.func
            called = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if called in names and isinstance(node.args[0].value, str):
                yield node.args[0].value


def test_every_span_the_package_opens_is_in_spans():
    opened, counted = set(), set()
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        opened |= set(_literal_calls(tree, {"span", "stage"}))
        counted |= set(_literal_calls(tree, {"count"}))
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert opened == set(profiling.SPANS)
    assert counted == set(profiling.COUNTERS)

