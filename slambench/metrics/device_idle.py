"""device_idle: the share of the traced window in which no operation ran
on the device (1 - the union of CUDA kernel, copy and set intervals over
the window's wall time). High: the host's launches pace the device."""

LAYER = "device"
UNIT = "share"
MOVES = "kf_per_s"
WRAPS = "batch._process_sessions_batched"


def read(rec):
    if not rec.trace.ops:
        return None
    return 1.0 - rec.trace.busy_s() / rec.trace.window_s
