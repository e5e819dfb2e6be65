"""boundary_host_ms: host wall time of one pass boundary, the program's
own span batch.boundary (batch.batched_increment_pass: the host's read
and compaction, the sweep's inputs, the ICP call, the per-lane rebuild
and the lane LM with its host read an iteration), the mean over the
counting job's boundaries. The program's recorder is on around each
boundary in the counting job (slambench.program_spans). Unlike the
keyframe step, the boundary syncs, so this is its host wall time with the
device's waits in it. boundary_syncs' sync debug mode runs inside the
span (PERF.md gives what it adds). This reader also puts the span summary
of the boundaries and the program's counters into the trace line's
notes. A program without the recorder reads nothing."""

from slambench import program_spans

LAYER = "batch"
UNIT = "ms"
MOVES = "kf_per_s"
WRAPS = "batch.batched_increment_pass"
SPAN = "batch.boundary"
KEY = "boundary_host_ms"


def wrap(fn, rec):
    return program_spans.wrap(fn, rec, KEY)


def read(rec):
    acc = rec.counters.get(KEY)
    if acc:
        for f in ("count", "total_ms"):
            rec.notes[f"boundary_span_{f}"] = {name: s[f] for name, s in sorted(acc["spans"].items())}
        rec.notes["boundary_counters"] = dict(sorted(acc["counters"].items()))
    return program_spans.mean_ms(rec, KEY, SPAN)
