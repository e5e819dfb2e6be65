"""The long-term mapping cells, multipass.boundary32 (the pass boundary
alone) and longterm.gdc32 (four passes at the runner's capacity), at a
CPU size built on tiny.py's copy of the benchmark: a sound run passes the
check and the control (the reference in TF32 in the program's place)
fails it; a boundary left undone fails it; the two boundary readers read
a sound run, and on a program without the sweep counters
boundary_pad_share reads nothing and the run goes on."""

import json

import pytest

from dpg_slam_tpu_torch.utils import profiling
from slambench import check, run
from slambench.tests import test_slambench_check as faults
from slambench.tests import tiny

CELLS = ("multipass.boundary32", "longterm.gdc32")


def _spec(tmp, cell: str) -> dict:
    """tiny.py's benchmark, with office-gdc4 holding four passes of one
    lap (256 node slots) and both new traffic mixes cut to 2 lanes of one
    lap."""
    bench = tiny.build(tmp)
    path = tmp / "configs" / "office-gdc4.json"
    doc = json.loads(path.read_text())
    doc["config"]["capacity"].update(max_nodes=256, max_edges=1024)
    path.write_text(json.dumps(doc))
    for name in ("boundary32", "gdc32"):
        t = json.loads((tiny.SRC / "traffic" / f"{name}.json").read_text())
        t.update(lanes=2, laps=1)
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return run.load_cell(cell, bench, tmp)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_longterm")
    return {c: _spec(d, c) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_and_control_fails(specs, cell):
    c = run.Cell(specs[cell], 21, "cpu")
    final, _, nodes, items = c.captured_job()
    assert len(items["boundary"]) == c.planned()["boundary"] > 0
    ok, table = check.judge(c.numbers(items, [nodes], final), specs[cell]["limits"])
    assert ok, table
    ok, table = check.judge(c.control_numbers(items), specs[cell]["limits"])
    assert not ok, table


@pytest.mark.parametrize("fault", ["boundary_unchanged", "boundary_lane_unchanged"])
def test_broken_boundary_is_not_correct(specs, monkeypatch, fault):
    module, attr, make = faults.FAULTS[fault]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    out = run.run_cell(specs["multipass.boundary32"], 23, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]


def _without_sweep_counters(count):
    return lambda name, n=1: None if name.startswith("boundary.sweep_") else count(name, n)


@pytest.mark.parametrize("counters", ["present", "absent"])
def test_boundary_readers(specs, monkeypatch, counters):
    if counters == "absent":
        monkeypatch.setattr(profiling, "count", _without_sweep_counters(profiling.count))
    out = run.run_cell(specs["multipass.boundary32"], 5, 0.0, True, device="cpu")
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["boundary_host_ms"]["value"] > 0
    if counters == "present":
        assert 0.0 <= m["boundary_pad_share"]["value"] < 1.0
    else:
        assert "boundary_pad_share" not in m
