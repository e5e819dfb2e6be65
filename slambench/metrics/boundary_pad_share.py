"""boundary_pad_share: the share of the pass boundary's K1 launch that is
padding, 1 - boundary.sweep_pairs / boundary.sweep_slots: the program's
counters of the sweep's live pairs (summed over the lanes' compactions)
and of the S x B pairs handed to icp_align (every lane padded to the
longest lane's count), summed over the counting job's boundaries. Lanes
of unequal history in one launch raise it. Host-known counts: no device
read. A program without those counters reads nothing."""

LAYER = "kernels"
UNIT = "share"
MOVES = "kf_per_s"
WRAPS = "batch.batched_increment_pass"
NAMES = ("boundary.sweep_pairs", "boundary.sweep_slots")


def _counters() -> dict:
    from dpg_slam_tpu_torch.utils import profiling

    return profiling.counters() if hasattr(profiling, "counters") else {}


def wrap(fn, rec):
    def call(*a, **k):
        before = _counters()
        out = fn(*a, **k)
        after = _counters()
        for name in NAMES:
            if name in after:
                rec.counters[name] = rec.counters.get(name, 0) + after[name] - before.get(name, 0)
        return out
    return call


def read(rec):
    slots = rec.counters.get("boundary.sweep_slots")
    if not slots:
        return None
    return 1.0 - rec.counters.get("boundary.sweep_pairs", 0) / slots
