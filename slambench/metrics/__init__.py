"""Per-layer metrics, one reader a file, found by the metric's name.

A reader gives LAYER, UNIT, MOVES and WRAPS (the program function,
relative to dpg_slam_tpu_torch, around which the traced job opens a
profiler range of that name), optionally wrap(fn, record) (a counter
around WRAPS, installed in the counting job that runs before the traced
job and is not traced; host time it spends on its own work goes into
record.instrument_s), and read(record) -> float or None. record.trace is
a slambench.trace.Trace of the traced job, record.keyframes its
keyframes, record.counters what the wrappers counted. A reader that finds
nothing to read returns None, and the metric is left out of the result
line."""
