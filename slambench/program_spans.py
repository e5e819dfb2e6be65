"""The program's own spans and counters (dpg_slam_tpu_torch.utils.profiling),
read in the counting job. A reader's wrap turns the program's recorder on
around each call of the function it wraps; each call's span summary
(count, total_ms, self_ms by span) and the change of the program's
counters are summed into record.counters under the reader's key. No
profiler runs there, so the spans open no range anyone records. A program
without the recorder is called as it is and nothing is summed: the
reader then reads nothing."""

from __future__ import annotations


def _recorder():
    from dpg_slam_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") and hasattr(profiling, "counters") else None


def wrap(fn, rec, key: str):
    prof = _recorder()
    if prof is None:
        return lambda *a, **k: fn(*a, **k)

    def call(*a, **k):
        before = prof.counters()
        with prof.tracing() as got:
            out = fn(*a, **k)
        after = prof.counters()
        acc = rec.counters.setdefault(key, dict(spans={}, counters={}))
        for name, s in got.summary().items():
            e = acc["spans"].setdefault(name, dict(count=0, total_ms=0.0, self_ms=0.0))
            for f in e:
                e[f] += s[f]
        for name, n in after.items():
            if n != before.get(name, 0):
                acc["counters"][name] = acc["counters"].get(name, 0) + n - before.get(name, 0)
        return out
    return call


def mean_ms(rec, key: str, span: str):
    """Mean host ms of one span over the calls `key`'s wrapper saw, or None."""
    s = rec.counters.get(key, {}).get("spans", {}).get(span)
    return s["total_ms"] / s["count"] if s and s["count"] else None


def note(rec, key: str) -> None:
    """The whole summary and the counters into record.notes, as flat dicts
    (they appear on the run's trace line)."""
    acc = rec.counters.get(key)
    if not acc:
        return
    for f in ("count", "total_ms", "self_ms"):
        rec.notes[f"span_{f}"] = {name: s[f] for name, s in sorted(acc["spans"].items())}
    rec.notes["program_counters"] = dict(sorted(acc["counters"].items()))
