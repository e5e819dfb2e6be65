"""launches_per_kf: CUDA kernels, copies and sets in the traced window
per keyframe: the host work the batched step costs, since each operation
takes ~10-20 us of host time to issue."""

LAYER = "batch"
UNIT = "ops/kf"
MOVES = "kf_per_s"
WRAPS = "batch._lanes_keyframe"


def read(rec):
    if not rec.trace.ops or not rec.keyframes:
        return None
    return len(rec.trace.ops) / rec.keyframes
