"""boundary_syncs: host syncs inside one pass boundary
(batch.batched_increment_pass), by torch's sync debug mode, in the
counting job (the debug mode stays out of the traced job): the lane LM
reads the host once an iteration, plus the boundary's per-lane host
work; the mean over the job's boundaries. Each is a round trip the
multipass job's keyframes wait for."""

from slambench.instrument import count_syncs

LAYER = "batch"
UNIT = "syncs"
MOVES = "kf_per_s"
WRAPS = "batch.batched_increment_pass"


def wrap(fn, rec):
    def call(*a, **k):
        out, n = count_syncs(lambda: fn(*a, **k))
        if n is not None:
            rec.counters.setdefault("boundary_syncs", []).append(n)
        return out
    return call


def read(rec):
    got = rec.counters.get("boundary_syncs")
    return sum(got) / len(got) if got else None
