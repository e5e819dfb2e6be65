"""Tracing and per-stage timing — the port's counterpart of
dpg_slam_tpu/utils/profiling.py.

``device_trace`` records the enclosed block with torch.profiler (CPU and,
where there is a card, CUDA activity) and writes a Chrome trace under its
directory, viewable in Perfetto or chrome://tracing. ``StageTimer``
accumulates wall-clock per named stage, with the JAX package's summary
schema; given a ``sync`` (torch.cuda.synchronize on the card) it waits for
the device before every clock read, so a stage's time is the device's
wall time and not the time to issue its work. The runner exposes both as
``run.py --profile``.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import time
from typing import Callable

import torch

__all__ = ["device_trace", "StageTimer", "TRACE_FILE"]

TRACE_FILE = "trace.json"


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
    """Accumulates wall-clock per named stage.

    Usage:
        timer = StageTimer(sync=torch.cuda.synchronize)
        with timer("icp"):
            result = run_icp(...)
        timer.summary()  # {'icp': {'count': 1, 'total_s': ..., 'mean_ms': ...}}
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
