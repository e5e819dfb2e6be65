"""solve_host_ms: host wall time of one lane solve, the program's own span
batch.solve (batch._adopt_solve: solve_batched's assemblies and per-lane
factorizations, every LM iteration, and the adoption of the poses), the
mean over the counting job's solves. The program's recorder is on around
each call of the keyframe loop in the counting job
(slambench.program_spans); the span never syncs, so this is the host's
time to issue the solve. No other reader's wrapper runs inside the span.
A program without the recorder reads nothing."""

from slambench import program_spans

LAYER = "graph.factor_graph"
UNIT = "ms"
MOVES = "kf_per_s"
WRAPS = "batch._process_sessions_batched"
SPAN = "batch.solve"
KEY = "solve_host_ms"


def wrap(fn, rec):
    return program_spans.wrap(fn, rec, KEY)


def read(rec):
    return program_spans.mean_ms(rec, KEY, SPAN)
