"""The harness finds a configuration, a traffic mix and a metric by name
alone, and BENCHMARK.json keeps to the benchmark's naming rules."""

import json
import re

import pytest

from slambench import check, run
from slambench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_new_files_are_found_by_name(tmp_path):
    bench_path = tiny.build(tmp_path)
    bench = json.loads(bench_path.read_text())
    cfg = json.loads((tmp_path / "configs" / "office-fleet.json").read_text())
    (tmp_path / "configs" / "office-two.json").write_text(json.dumps(cfg))
    traffic = json.loads((tmp_path / "traffic" / "track64.json").read_text())
    traffic["sessions"] = 2
    (tmp_path / "traffic" / "track2.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics" / "traced_keyframes.py").write_text(
        'LAYER = "batch"\nUNIT = "kf"\nMOVES = "kf_per_s"\nWRAPS = "batch._lanes_keyframe"\n\n\n'
        "def read(rec):\n    return float(rec.keyframes)\n")
    bench["configs"].append(dict(name="office-two", source="a test", file=str(tmp_path / "configs" / "office-two.json"),
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="fleet.track2", config="office-two", traffic="track2", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="traced_keyframes", unit="kf", better="higher", source="program_counter",
                                   layer="batch", moves="kf_per_s", workloads=["fleet.track2"]))
    bench_path.write_text(json.dumps(bench))
    (tmp_path / "limits" / "fleet.track2.json").write_text((tmp_path / "limits" / "fleet.track64.json").read_text())
    spec = run.load_cell("fleet.track2", bench_path, tmp_path)
    assert spec["traffic"]["sessions"] == 2 and [m["name"] for m in spec["per_layer"]] == ["traced_keyframes"]
    out = run.run_cell(spec, 5, 0.0, True, device="cpu")
    assert out["metrics"]["traced_keyframes"]["value"] > 0
    assert out["correct"], out["checks"]


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("slambench/")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (ROOT / "slambench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "slambench" / "limits" / f"{w['name']}.json").is_file()
    for word in BENCH["command"]:
        assert TEXT.match(word)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_metric_is_reported_where_it_moves(cell):
    spec = run.load_cell(cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], cell)
    for m in spec["per_layer"]:
        reader = spec["readers"][m["name"]]
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"]), m["name"]
    assert set(spec["limits"]) == check.number_names(spec["driver"].STAGES)
