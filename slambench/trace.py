"""Reduction of one torch.profiler trace (CPU and CUDA activities) to what
the per-layer metrics read: device operations with the host time of
their launch (the runtime call that launched them), the benchmark's host
ranges, the device's busy time as the union of its operation intervals inside the
traced window, and the breakdown (device operations by total time, idle
gaps by the innermost host range open when they started)."""

from __future__ import annotations

import collections

import numpy as np

WINDOW = "slambench.window"


class Trace:
    """range_names: the benchmark's host ranges (their device-side copies,
    which the profiler also records, are not operations)."""

    def __init__(self, events, range_names):
        names = set(range_names) | {WINDOW}
        launches = {}
        ops, ranges = [], collections.defaultdict(list)
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type().name != "CPU":
                if name not in names:
                    ops.append((start, end, name, e.correlation_id()))
            elif name in names:
                ranges[name].append((start, end))
            elif name.startswith("cu"):
                launches[e.correlation_id()] = start
        if WINDOW not in ranges:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1 = ranges[WINDOW][0]
        ops = [o for o in ops if o[1] > self.t0 and o[0] < self.t1]
        ops.sort()
        self.ops = ops
        self.launch_ns = np.array([launches.get(o[3], o[0]) for o in ops], dtype=np.int64)
        self.ranges = {k: sorted(v) for k, v in ranges.items() if k != WINDOW}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device (the union of
        the operation intervals, clipped to the window)."""
        busy, end = 0, self.t0
        for s, e, _, _ in self.ops:
            s, e = max(s, end), min(e, self.t1)
            if e > s:
                busy += e - s
                end = e
        return busy * 1e-9

    def in_ranges(self, name: str, times: np.ndarray) -> np.ndarray:
        """Bool mask of host times that lie inside one of the ranges `name`."""
        spans = self.ranges.get(name, [])
        if not spans:
            return np.zeros(times.shape, bool)
        starts = np.array([s for s, _ in spans])
        ends = np.array([e for _, e in spans])
        i = np.searchsorted(starts, times, side="right") - 1
        return (i >= 0) & (times <= ends[np.clip(i, 0, None)])

    def device_s_launched_in(self, name: str) -> float:
        """Device seconds of the operations launched inside ranges `name`."""
        if not self.ops:
            return 0.0
        mask = self.in_ranges(name, self.launch_ns)
        return float(sum(o[1] - o[0] for o, m in zip(self.ops, mask) if m)) * 1e-9

    def range_count(self, name: str) -> int:
        return len(self.ranges.get(name, []))

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for s, e, n, _ in self.ops:
            by[n] += (e - s) * 1e-9
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time summed by the innermost benchmark range open on
        the host when each gap began ("outside" where none was)."""
        gaps, end = [], self.t0
        for s, e, _, _ in self.ops:
            if s > end:
                gaps.append((end, s - end))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1 - end))
        marks = []
        for name, spans in self.ranges.items():
            for s, e in spans:
                marks.append((s, 0, name))
                marks.append((e, 2, name))
        marks += [(t, 1, d) for t, d in gaps]
        marks.sort(key=lambda m: (m[0], m[1]))
        stack, by = [], collections.Counter()
        for t, kind, x in marks:
            if kind == 0:
                stack.append(x)
            elif kind == 2:
                if x in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(x)]
            else:
                by[stack[-1] if stack else "outside"] += x * 1e-9
        return [[n, t] for n, t in by.most_common(top)]
