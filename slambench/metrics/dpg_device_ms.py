"""dpg_device_ms: device time of the operations one DPG step
(batch._lanes_dpg) launches, the mean over the traced job's steps."""

LAYER = "dpg.change_detection"
UNIT = "ms"
MOVES = "kf_per_s"
WRAPS = "batch._lanes_dpg"


def read(rec):
    n = rec.trace.range_count(WRAPS)
    if not n or not rec.trace.ops:
        return None
    return 1e3 * rec.trace.device_s_launched_in(WRAPS) / n
