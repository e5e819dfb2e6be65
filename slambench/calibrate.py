"""The readings the check's limits are set from: for each seed, the
numbers of the program's captured job against the reference, and the
control's (the reference in TF32 in the program's place), in one
process per cell.

    python3 -m slambench.calibrate --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

Prints one JSON line a seed. It needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from slambench import run


def _lanes(calls, ref_calls) -> dict:
    """The copied solves' or boundaries' per-lane edge gaps: quartiles,
    the 90th percentile and the largest, and the lanes over 1, 2, 5 and
    10 mm (the readings of the median and the lane share)."""
    import torch

    from slambench import check

    g = [check._edge_gaps(p["poses"], q["poses"], q["graph"]) for p, q in zip(calls, ref_calls)]
    if not g:
        return {}
    g = torch.cat(g).double().cpu()
    return dict(q=torch.quantile(g, torch.tensor([0.25, 0.5, 0.75, 0.9], dtype=g.dtype)).tolist(),
                max=float(g.max()), lanes=int(g.numel()),
                over={str(t): int((g > t).sum()) for t in (1e-3, 2e-3, 5e-3, 1e-2)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    run._set_caches()
    spec = run.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("slambench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    warm = False
    for seed in args.seeds:
        t = time.time()
        cell = run.Cell(spec, seed, "cuda")
        if not warm:
            cell.job()
            warm = True
        final, kf, nodes, items = cell.captured_job()
        t1 = time.time()
        out = dict(cell=args.workload, seed=seed, keyframes=kf, program=cell.numbers(items, [nodes], final))
        out["check_s"] = time.time() - t1
        for k in ("solve", "boundary"):
            out[f"{k}_lanes"] = _lanes(items[k], cell._ref[k])
        # A boundary that returns its poses unchanged, at the cell's size.
        out["boundary_unchanged_lanes"] = _lanes([dict(poses=it["inp"]["poses"]) for it in items["boundary"]],
                                                 cell._ref["boundary"])
        if seed in args.control_seeds:
            out["control"] = cell.control_numbers(items)
            for k in ("solve", "boundary"):
                out[f"control_{k}_lanes"] = _lanes(cell._ctl[k], cell._ref[k])
        out["seconds"] = time.time() - t
        print(json.dumps(out), flush=True)
        del final, items, cell
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
