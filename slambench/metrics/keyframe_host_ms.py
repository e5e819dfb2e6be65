"""keyframe_host_ms: host wall time of one batched keyframe step, the
program's own span batch.keyframe (batch._lanes_keyframe: node writes,
closure candidates, the ICP call, the vote, the factor appends), the mean
over the counting job's steps. The program's recorder is on around each
call of the keyframe loop in the counting job (slambench.program_spans);
the span never syncs, so this is the host's time to issue the step, which
sets the pace while the device idles. k1_roofline's wrapper runs inside
the span (its sums at each K1 launch; PERF.md gives what they add). This
reader also puts the job's whole span summary and the program's counters
into the trace line's notes. A program without the recorder reads
nothing."""

from slambench import program_spans

LAYER = "batch"
UNIT = "ms"
MOVES = "kf_per_s"
WRAPS = "batch._process_sessions_batched"
SPAN = "batch.keyframe"
KEY = "keyframe_host_ms"


def wrap(fn, rec):
    return program_spans.wrap(fn, rec, KEY)


def read(rec):
    program_spans.note(rec, KEY)
    return program_spans.mean_ms(rec, KEY, SPAN)
