#!/usr/bin/env python3
"""Phase times of chip_smoke.py on two trees of the port, in turns, on one
NVIDIA GPU.

    python3 tools/compare_trees.py <other tree> [order] [log dir]

Runs `python3 chip_smoke.py` from the root of this tree ("change") and of
<other tree> (an unpacked commit, "parent") in the given order (default
"PCCP": parent, change, change, parent), each in its own process. The logs
go to <log dir>/compare_<i>_<tree>.log (default build/compare, under this
tree). Prints one JSON line per run with the wall seconds of the script
and the numbers of phases 3, 5, 9 and 11a: keyframe kf/s, reoptimize
seconds, batched kf/s (median of 3) and multipass kf/s (median of 2);
then the card's nvidia-smi line. A run that fails is reported with its
exit code and the end of its log.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (chip_smoke phase, field) per reported number.
FIELDS = {"keyframe_kf_per_s": ("keyframe", "kf_per_s"), "reoptimize_s": ("reoptimize", "seconds"),
          "batched_kf_per_s": ("batched", "kf_per_s"), "multipass_kf_per_s": ("multipass", "kf_per_s")}


def run(tree: pathlib.Path, log: pathlib.Path) -> dict:
    t0 = time.perf_counter()
    with log.open("w") as f:
        rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f, stderr=subprocess.STDOUT).returncode
    out = dict(rc=rc, seconds=time.perf_counter() - t0)
    lines = [json.loads(x) for x in log.read_text().splitlines() if x.startswith('{"phase"')]
    for key, (phase, field) in FIELDS.items():
        out[key] = next((x[field] for x in lines if x["phase"] == phase and field in x), None)
    if rc:
        out["log_tail"] = log.read_text()[-2000:]
    return out


def main() -> None:
    other = pathlib.Path(sys.argv[1]).resolve()
    order = sys.argv[2] if len(sys.argv) > 2 else "PCCP"
    trees = {"P": ("parent", other), "C": ("change", ROOT)}
    outdir = pathlib.Path(sys.argv[3]).resolve() if len(sys.argv) > 3 else ROOT / "build" / "compare"
    outdir.mkdir(parents=True, exist_ok=True)
    for i, key in enumerate(order):
        name, tree = trees[key]
        print(json.dumps({"run": i, "tree": name, **run(tree, outdir / f"compare_{i}_{name}.log")}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
