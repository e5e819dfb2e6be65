"""The benchmark of dpg_slam_tpu_torch on one NVIDIA card: one cell, one run.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json, which
names its driver in drivers/); its metrics are BENCHMARK.json's entries
that list the cell, each per-layer metric a reader in metrics/<name>.py,
and its limits limits/<cell>.json. A run:

  1. finds the card (without one, or with fewer than the cell asks for,
     it exits 2 and prints no result);
  2. makes the cell's inputs from --seed with the benchmark's simulator;
  3. runs one untimed warm job (the first run in a checkout also builds
     K1 into build/kernels/; every cache lives under build/);
  4. --trace 0: runs whole jobs back to back for at least --seconds (the
     window; the first job also copies the stages the check compares);
     --trace 1: runs the check's job, then a job with the per-layer
     readers' counters (untraced), then one job under torch.profiler with
     the readers' ranges and nothing else of the benchmark's;
  5. reads the peak memory, frees the program's state, and compares the
     copied results with the plain reference (slambench/reference);
  6. prints one JSON line: correct, attempted, failed, metrics, device,
     breakdown (with --trace 1) and the compared numbers with their limits,
     which are also the last lines on standard error.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "slambench"
FORBIDDEN = {"jax", "jaxlib", "flax", "dpg_slam_tpu"}


def _set_caches() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_path: pathlib.Path = ROOT / "BENCHMARK.json", here: pathlib.Path = HERE) -> dict:
    """Everything a cell's run needs, found by name: its entry, its
    configuration file, its traffic file, its driver, its metrics and its
    limits."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((bench_path.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name] if m["moves"] in moves else [])]
    limits_path = here / "limits" / f"{name}.json"
    return dict(
        cell=cell, config=config, traffic=traffic, end_to_end=e2e, per_layer=layer,
        driver=load_module(here / "drivers" / f"{traffic['driver']}.py", f"slambench_driver_{traffic['driver']}"),
        readers={m["name"]: load_module(here / "metrics" / f"{m['name']}.py", f"slambench_metric_{m['name']}")
                 for m in layer},
        limits=json.loads(limits_path.read_text())["limits"] if limits_path.exists() else {},
    )


def nvidia_smi() -> dict:
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return dict(error=str(e))
    return dict(zip(q.split(","), out[0].split(", "))) if out else {}


def emit(**fields) -> None:
    print(json.dumps(fields), file=sys.stderr, flush=True)


class Record:
    """What a traced run hands the per-layer readers: the counters their
    wrappers kept in the counting job (and the host seconds the wrappers
    spent on their own work, instrument_s), the trace of the traced job
    and its keyframes."""

    def __init__(self):
        self.counters: dict = {}
        self.notes: dict = {}
        self.instrument_s = 0.0
        self.trace = None
        self.keyframes = 0


@contextlib.contextmanager
def quiet_host():
    """No cyclic garbage collection inside the window: a collection of the
    program's many small objects would land in one job at random."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def host_clock() -> tuple[float, float]:
    """The wall clock and the main thread's CPU seconds: a job's CPU
    seconds against its wall seconds say whether the host was slow or the
    thread waited."""
    return time.perf_counter(), time.thread_time()


class Cell:
    """One cell's set-up for one seed: the program's configuration, the
    reference's, the inputs, and the calls the check copies (drawn from
    the seed)."""

    def __init__(self, spec: dict, seed: int, device: str):
        import numpy as np

        from slambench import reference
        from dpg_slam_tpu_torch.config import DpgConfig

        self.device = device
        self.driver, self.traffic = spec["driver"], spec["traffic"]
        self.cfg = DpgConfig.from_dict(spec["config"]["config"])
        self.cfg_ref = reference.config(spec["config"]["config"])
        self.inputs = self.driver.make_inputs(self.cfg_ref, self.traffic, seed)
        calls = self.driver.stage_calls(self.cfg_ref, self.traffic, self.inputs)
        rng = np.random.default_rng([seed, 0x51A])
        self.plan = {}
        for k, pool in calls.items():
            pool = list(range(pool)) if isinstance(pool, int) else list(pool)
            n = min(len(pool), self.traffic["check"].get(k, 0))
            self.plan[k] = sorted(int(i) for i in rng.choice(pool, size=n, replace=False)) if n else []

    def sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def job(self):
        """One job, ended by a sync: (stacked states, keyframes)."""
        import dpg_slam_tpu_torch as prog

        states, kf = self.driver.run_job(prog, self.cfg, self.traffic, self.inputs, self.device)
        self.sync()
        return states, kf

    def captured_job(self):
        """A job that also copies the stages the check compares: (final
        state as the check reads it, keyframes, node counts, copies)."""
        from slambench import capture

        cap = capture.Capture(self.plan).install()
        try:
            final, kf = self.job()
        finally:
            cap.remove()
        state = {f: getattr(final, f) for f in ("ranges", "cloud", "cloud_mask", "cloud_normals", "num_nodes")}
        return state, kf, final.num_nodes.cpu().numpy(), cap.items

    def numbers(self, items, job_nodes, final) -> dict:
        """The program's numbers against the reference."""
        from slambench import check
        from slambench.reference import geom

        ref = check.outputs(self.cfg_ref, self.inputs["lane_passes"], items, geom.exact, self.device)
        self._ref = ref
        return check.compare(self.cfg_ref, check.program_outputs(items, job_nodes, final), ref, self.driver.STAGES,
                             self.planned())

    def control_numbers(self, items) -> dict:
        """The control's numbers: the reference in TF32 in the program's
        place (after numbers(), whose reference outputs it reuses)."""
        from slambench import check
        from slambench.reference import geom

        self._ctl = check.outputs(self.cfg_ref, self.inputs["lane_passes"], items, geom.tf32, self.device)
        return check.compare(self.cfg_ref, self._ctl, self._ref, self.driver.STAGES, self.planned())

    def planned(self) -> dict:
        return {k: len(v) for k, v in self.plan.items()}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of one cell on `device` (the CPU only in the benchmark's
    own tests). Returns the result dict (printed by main)."""
    import torch

    from slambench import check
    from slambench.instrument import Patches, ranged
    from slambench.trace import WINDOW, Trace

    t_import = time.time()
    cell = Cell(spec, seed, device)
    t_inputs = time.time()
    cell.job()  # warm: every shape of this cell's traffic, and K1's build
    gc.collect()
    emit(line="setup", start_to_run_cell_s=t_import - T_START, inputs_s=t_inputs - t_import,
         warm_job_s=time.time() - t_inputs)
    # The window (--trace 0): the check's job, then whole jobs until --seconds.
    with quiet_host():
        t_setup = time.time()
        h0 = host_clock()
        final, keyframes, nodes, items = cell.captured_job()
        job_nodes, attempted = [nodes], 1
        result: dict = {}
        if not trace:
            h1 = host_clock()
            jobs = [(h1[0] - h0[0], h1[1] - h0[1])]
            while time.time() - t_setup < seconds:
                h0 = host_clock()
                states, kf = cell.job()
                h1 = host_clock()
                jobs.append((h1[0] - h0[0], h1[1] - h0[1]))
                job_nodes.append(states.num_nodes.cpu().numpy())
                del states
                attempted += 1
                keyframes += kf
            t_end = time.time()
        else:
            rec = Record()
            readers = [spec["readers"][m["name"]] for m in spec["per_layer"]]
            # The readers' counters run in a job of their own, which the
            # profiler does not see: their work and syncs stay out of the trace.
            with Patches() as p:
                for r in readers:
                    if hasattr(r, "wrap"):
                        p.wrap(r.WRAPS, lambda fn, r=r: r.wrap(fn, rec))
                states, kf = cell.job()
            job_nodes.append(states.num_nodes.cpu().numpy())
            del states
            spans = sorted({r.WRAPS for r in readers} | set(cell.traffic.get("spans", [])))
            with Patches() as p:
                for t in spans:
                    p.wrap(t, ranged(t))
                from torch.profiler import ProfilerActivity, profile, record_function

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
                with profile(activities=acts) as prof:
                    with record_function(WINDOW):
                        states, rec.keyframes = cell.job()
            job_nodes.append(states.num_nodes.cpu().numpy())
            del states
            attempted += 2
    if not trace:
        metrics = dict(kf_per_s=dict(value=keyframes / (t_end - t_setup), unit="kf/s"),
                       setup_s=dict(value=t_setup - T_START, unit="s"))
        emit(line="window", seconds=t_end - t_setup, jobs=attempted, keyframes=keyframes,
             job_s=[w for w, _ in jobs], job_cpu_s=[c for _, c in jobs])
    else:
        rec.trace = Trace(prof.profiler.kineto_results.events(), spans)
        del prof
        metrics = {}
        for m in spec["per_layer"]:
            v = spec["readers"][m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        result["breakdown"] = dict(device_ops=rec.trace.device_ops(), idle_gaps=rec.trace.idle_gaps())
        busy = rec.trace.busy_s()
        emit(line="trace", window_s=rec.trace.window_s, busy_s=busy, device_ops=len(rec.trace.ops),
             keyframes=rec.keyframes, notes={k: {a: float(b) for a, b in v.items()} for k, v in rec.notes.items()})
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    gc.collect()
    nums = cell.numbers(items, job_nodes, final)
    correct, table = check.judge(nums, spec["limits"])
    device_info = dict(platform="gpu" if device == "cuda" else device,
                       kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
                       count=1, memory_peak_bytes=int(peak))
    if trace:
        device_info.update(busy_s=busy, window_s=rec.trace.window_s)
    result = dict(correct=bool(correct), attempted=attempted, failed=0 if correct else 1, metrics=metrics,
                  device=device_info, **result)
    result["checks"] = table
    return result


def _forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_caches()
    spec = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"slambench: {args.workload} needs {spec['cell']['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    emit(line="context", cell=args.workload, seed=args.seed, seconds=args.seconds, trace=args.trace,
         torch=torch.__version__, cuda=torch.version.cuda, card=torch.cuda.get_device_name(0),
         cards=torch.cuda.device_count(), nvidia_smi=nvidia_smi())
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    emit(line="context_after", nvidia_smi=nvidia_smi())
    bad = _forbidden_loaded()
    if bad:
        print(f"slambench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, t in result["checks"].items():
        print(f"check {k} = {t['value']!r} (limit {t['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
