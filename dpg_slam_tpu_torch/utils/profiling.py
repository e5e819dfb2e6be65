"""Tracing, spans, counters and per-stage timing — the port's counterpart
of dpg_slam_tpu/utils/profiling.py.

``device_trace`` records the enclosed block with torch.profiler (CPU and,
where there is a card, CUDA activity) and writes a Chrome trace under its
directory, viewable in Perfetto or chrome://tracing.

The recorder: the package opens a ``span(name)`` at each layer boundary
of its batched paths (every name is in ``SPANS``). Off, the default, a
span is one shared null context: it records nothing and calls no torch
API. Inside ``tracing()`` a span records (name, start, end, parent, job)
on the host's clock (time.perf_counter_ns) and, while torch.profiler
records, opens a record_function range of its name, so the device's
operations and idle gaps sit under the span the host was in.
A span never syncs and never reads a device value: its time is the host's
time to issue the work. ``job()`` marks one top-level call (a batched or
multipass job, a server step, an engine call); every span inside it
shares its id. Spans stay in memory and leave only through ``summary()``
or the profiler's trace.

``count(name, n)`` adds host-known numbers (shapes, loop trips, lane
lists) to a plain dict of integers, whether tracing is on or not; no
counter adds a device operation or a host read. ``counters()`` copies it.

``StageTimer`` accumulates wall-clock per named stage, with the JAX
package's summary schema, and records each stage as a span; given a
``sync`` (torch.cuda.synchronize on the card) it waits for the device
before every clock read, so a stage's time is the device's wall time and
not the time to issue its work. The runner exposes the trace, the spans
and the timer as ``run.py --profile``.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import time
from typing import Callable, NamedTuple

import torch

__all__ = [
    "COUNTERS", "SPANS", "SpanRecord", "StageTimer", "TRACE_FILE", "count", "counters", "device_trace", "job",
    "reset_counters", "span", "summary", "tracing",
]

TRACE_FILE = "trace.json"

# Every span the package opens, by layer (PERF.md's table names the
# per-layer metric each is for).
SPANS = (
    # batch: the batched and multipass loops, and the pass boundary
    "batch.schedule", "batch.loop",
    "batch.keyframe", "batch.keyframe.nodes", "batch.keyframe.candidates", "batch.keyframe.factors",
    "batch.solve", "batch.dpg",
    "batch.boundary", "boundary.read", "boundary.inputs", "boundary.rebuild",
    # graph.factor_graph: the lane LM solves
    "graph.solve_batched", "graph.solve_lanes", "graph.assemble", "graph.factor",
    # dpg.change_detection: one DPG step on every lane
    "dpg.step", "dpg.chain", "dpg.register", "dpg.grids", "dpg.candidates", "dpg.commit", "dpg.punch",
    # kernels: every ICP call (K1 on the card)
    "icp.align",
    # run: the runner's stages (StageTimer)
    "observe_odometry", "observe_laser", "process_sequence", "reoptimize",
)

# Every counter the package keeps.
COUNTERS = (
    "batch.keyframes",     # keyframes of the batched and multipass jobs and the server's steps
    "batch.steps",         # batched keyframe steps (stride padding included)
    "batch.lane_steps",    # steps x lanes: keyframes / lane_steps is the lane work that was not padding
    "batch.keyframe_graph_captures",  # keyframe loops that captured their step as CUDA graphs
    "batch.keyframe_graph_replays",   # keyframe steps replayed from those graphs
    "k1.launches",         # launches of kernel K1 (ops/icp_cuda.run_kernel)
    "k1.pairs",            # pairs handed to ops/icp.icp_align (K1 on the card, the plain loop on the CPU)
    "k2.launches",         # launches of kernel K2 (ops/schur_cuda.run_kernel)
    "graph.lm_iterations",  # LM loop trips of solve_batched and solve_lanes
    "graph.factorizations",  # per-lane cholesky_ex calls of the lane solves
    "host.reads",          # explicit reads of a device value on the batched paths
    "boundary.sweep_pairs",  # live pairs of the pass boundary's ICP sweeps, summed over the lanes
    "boundary.sweep_slots",  # pairs those sweeps hand to icp_align, padding included (lanes x common count)
)


class SpanRecord(NamedTuple):
    """One closed span: times in host nanoseconds (time.perf_counter_ns);
    parent and id are span ids (parent None at a job's top), job the id
    shared by the spans of one top-level call."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    job: int
    id: int


_NULL = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


class _Recorder:
    """The recorder's state: how many tracing() blocks are open, the
    spans closed since the outermost opened, the open spans, the open job."""

    depth = 0
    records: list[SpanRecord] = []
    stack: list["_Span"] = []
    job: int | None = None
    next_id = 0
    next_job = 0


_R = _Recorder


class _Span:
    __slots__ = ("name", "id", "parent", "job", "start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = _R.next_id
        _R.next_id += 1
        top = _R.stack[-1] if _R.stack else None
        self.parent = top.id if top is not None else None
        if _R.job is not None:
            self.job = _R.job
        elif top is not None:
            self.job = top.job
        else:
            self.job = _R.next_job
            _R.next_job += 1
        _R.stack.append(self)
        # A range only where a profiler records (opening one costs ~10 us).
        self._range = torch.profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        if _R.stack and _R.stack[-1] is self:
            _R.stack.pop()
        if _R.depth:
            _R.records.append(SpanRecord(self.name, self.start, end, self.parent, self.job, self.id))
        return False


def span(name: str):
    """A context manager over one stage: the shared null context while
    tracing is off; inside tracing() a recorded span, and a profiler range
    of `name` while a profiler records (`name` must be in SPANS)."""
    if not _R.depth:
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def _job():
    if _R.job is not None:
        yield
        return
    _R.job = _R.next_job
    _R.next_job += 1
    try:
        yield
    finally:
        _R.job = None


def job():
    """Marks one top-level call: every span opened inside it shares one job
    id (a nested job() joins the open one). The null context while tracing
    is off."""
    if not _R.depth:
        return _NULL
    return _job()


class Recording:
    """The spans closed inside one tracing() block: live while the block is
    open, fixed once it has closed."""

    def __init__(self, start: int):
        self._start = start
        self._spans: list[SpanRecord] | None = None

    @property
    def spans(self) -> list[SpanRecord]:
        return self._spans if self._spans is not None else _R.records[self._start:]

    def summary(self) -> dict:
        return summary(self.spans)


@contextlib.contextmanager
def tracing():
    """Turns recording on for the enclosed block (blocks nest) and yields a
    Recording of the spans closed inside it:

        with profiling.tracing() as rec:
            process_sessions_batched(cfg, sessions)
        rec.summary()["batch.keyframe"]  # {'count': ..., 'total_ms': ..., 'self_ms': ...}
    """
    view = Recording(len(_R.records))
    _R.depth += 1
    try:
        yield view
    finally:
        _R.depth -= 1
        view._spans = _R.records[view._start:]
        if not _R.depth:
            _R.records = []
            _R.stack = []
            _R.job = None


def summary(spans) -> dict:
    """Per span name: count, total_ms and self_ms (the duration less the
    part its child spans cover)."""
    spans = list(spans)
    child_ns = collections.Counter()
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: dict = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        e = out.setdefault(s.name, dict(count=0, total_ms=0.0, self_ms=0.0))
        e["count"] += 1
        e["total_ms"] += d * 1e-6
        e["self_ms"] += (d - child_ns[s.id]) * 1e-6
    return out


def count(name: str, n: int = 1) -> None:
    """Adds the host-known int n to counter `name` (always, traced or not)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path):
    """Trace the enclosed block into ``<log_dir>/trace.json``:

        with device_trace("/tmp/trace"):
            engine.increment_pass()

    Yields the torch.profiler.profile object (key_averages() for sums by
    kernel)."""
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


class StageTimer:
    """Accumulates wall-clock per named stage; each stage is also a span
    of the recorder (its name must be in SPANS).

    Usage:
        timer = StageTimer(sync=torch.cuda.synchronize)
        with timer("observe_laser"):
            engine.observe_laser(scan)
        timer.summary()  # {'observe_laser': {'count': 1, 'total_s': ..., 'mean_ms': ...}}
    """

    def __init__(self, sync: Callable[[], None] | None = None):
        self._sync = sync
        self._acc = collections.defaultdict(float)
        self._cnt = collections.defaultdict(int)

    def _now(self) -> float:
        if self._sync is not None:
            self._sync()
        return time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, stage: str):
        with span(stage):
            t0 = self._now()
            try:
                yield
            finally:
                self._acc[stage] += self._now() - t0
                self._cnt[stage] += 1

    def summary(self) -> dict:
        return {
            k: {
                "count": self._cnt[k],
                "total_s": round(self._acc[k], 4),
                "mean_ms": round(1e3 * self._acc[k] / max(self._cnt[k], 1), 3),
            }
            for k in sorted(self._acc)
        }

    def reset(self) -> None:
        self._acc.clear()
        self._cnt.clear()
