"""solve_device_share: device time of the operations launched inside the
lane solve (batch._batched_solve), over all device busy time."""

LAYER = "graph.factor_graph"
UNIT = "share"
MOVES = "kf_per_s"
WRAPS = "batch._batched_solve"


def read(rec):
    busy = rec.trace.busy_s()
    if not busy or not rec.trace.range_count(WRAPS):
        return None
    return rec.trace.device_s_launched_in(WRAPS) / busy
