"""A small copy of the benchmark for CPU tests: the committed drivers,
metrics and limits with the cells' configurations and traffic cut to a
size the CPU runs in seconds (128 beams, 32 ICP points, 2 closures,
3 sessions of two laps, so that the second lap closes loops, or 2 lanes
of one lap)."""

from __future__ import annotations

import json
import pathlib
import shutil

SRC = pathlib.Path(__file__).resolve().parent.parent
ROOT = SRC.parent

CELLS = ("fleet.track64", "multipass.replay32")


def _tiny_config(doc: dict, multipass: bool) -> dict:
    c = doc["config"]
    c["scan"]["num_beams"] = 128
    c["pose_graph"].update(icp_max_points=32, icp_maximum_iterations=10, max_loop_closures_per_node=2)
    c["capacity"].update(max_nodes=128 if multipass else 64, max_edges=512 if multipass else 256, max_priors=4)
    c["dpg"].update(max_submap_nodes=4, grid_extent_cells=128, local_reg_max_points=256)
    return doc


def build(out: pathlib.Path) -> pathlib.Path:
    """Write the small benchmark under `out`; returns its BENCHMARK.json."""
    for d in ("drivers", "metrics", "limits"):
        shutil.copytree(SRC / d, out / d, dirs_exist_ok=True)
    (out / "traffic").mkdir(exist_ok=True)
    (out / "configs").mkdir(exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        (out / "configs" / f"{c['name']}.json").write_text(json.dumps(_tiny_config(doc, "multipass" in c["name"])))
        c["file"] = str(out / "configs" / f"{c['name']}.json")
    t = json.loads((SRC / "traffic" / "track64.json").read_text())
    t.update(sessions=3, laps=2, solve_bucket=64, solve_stride=4)
    (out / "traffic" / "track64.json").write_text(json.dumps(t))
    t = json.loads((SRC / "traffic" / "replay32.json").read_text())
    t.update(lanes=2, laps=1)
    (out / "traffic" / "replay32.json").write_text(json.dumps(t))
    path = out / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def spec(tmp: pathlib.Path, cell: str) -> dict:
    from slambench import run

    bench = build(tmp)
    return run.load_cell(cell, bench, tmp)
