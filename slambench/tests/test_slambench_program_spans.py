"""The readers of the program's own spans, keyframe_host_ms and
solve_host_ms, on the tiny CPU cells (the way
test_slambench_discovery.test_new_files_are_found_by_name runs one): each
reads a positive value and puts the span summary on the trace line, and
with or without them the cell reads the same launches_per_kf,
boundary_syncs and K1 launch count, and the program counts the same
work."""

import json

import pytest

from dpg_slam_tpu_torch.utils import profiling
from slambench import run
from slambench.tests import tiny

NEW = ("keyframe_host_ms", "solve_host_ms")
SAME = ("launches_per_kf", "boundary_syncs", "k1_roofline")


def _run(spec, capsys):
    before = profiling.counters()
    out = run.run_cell(spec, 5, 0.0, True, device="cpu")
    after = profiling.counters()
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines() if x.startswith("{")]
    notes = next(x for x in lines if x.get("line") == "trace")["notes"]
    return out, notes, {k: n - before.get(k, 0) for k, n in after.items()}


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_program_span_readers(tmp_path, capsys, cell):
    spec = tiny.spec(tmp_path, cell)
    assert {m["name"] for m in spec["per_layer"]} >= set(NEW)
    out, notes, work = _run(spec, capsys)
    assert out["correct"], out["checks"]
    for m in NEW:
        assert out["metrics"][m]["value"] > 0 and out["metrics"][m]["unit"] == "ms"
    assert notes["span_count"]["batch.keyframe"] > 0 and notes["span_count"]["batch.solve"] > 0
    assert notes["program_counters"]["batch.lane_steps"] > 0 and notes["program_counters"]["k1.pairs"] > 0
    assert all(notes["span_total_ms"][k] >= notes["span_self_ms"][k] for k in notes["span_count"])
    without = dict(spec, per_layer=[m for m in spec["per_layer"] if m["name"] not in NEW])
    out2, notes2, work2 = _run(without, capsys)
    assert "span_count" not in notes2
    for m in SAME:
        assert out["metrics"].get(m) == out2["metrics"].get(m), m
    assert notes["k1_roofline"] == notes2["k1_roofline"]  # the K1 launches counted and traced
    assert work == work2 and work["batch.keyframes"] > 0
