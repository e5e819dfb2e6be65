"""dpg_host_ms: host wall time of one DPG step (batch._lanes_dpg; it
enqueues the step and reads no host value), the mean over the counting
job's steps, on the host clock and without the profiler (the host time
the other readers' counters spend inside a step is taken off)."""

import time

LAYER = "dpg.change_detection"
UNIT = "ms"
MOVES = "kf_per_s"
WRAPS = "batch._lanes_dpg"


def wrap(fn, rec):
    def call(*a, **k):
        t, own = time.perf_counter(), rec.instrument_s
        out = fn(*a, **k)
        rec.counters.setdefault("dpg_host_s", []).append(time.perf_counter() - t - (rec.instrument_s - own))
        return out
    return call


def read(rec):
    got = rec.counters.get("dpg_host_s")
    return 1e3 * sum(got) / len(got) if got else None
