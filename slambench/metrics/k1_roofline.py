"""k1_roofline: K1's least time over its device time, in per cent. The
least time of each launch is the larger of its operations at the FP32
instruction rate and its bytes at HBM bandwidth (slambench.peaks.k1_work:
from the launch's valid sources x valid targets x (iterations in output
column 11 + 1)), summed over the counting job's launches on the device
and read once at the end; the device time is that of the kernels named
icp_p2l* in the traced job, which replays the same inputs. Where the two
jobs' launch counts differ, nothing is read."""

import time

import torch

from slambench import peaks

LAYER = "kernels"
UNIT = "%"
MOVES = "kf_per_s"
WRAPS = "ops.icp_cuda.run_kernel"
KERNEL = "icp_p2l"


def wrap(fn, rec):
    def call(src_planes, tgt_planes, seeds, params, *a, **k):
        out = fn(src_planes, tgt_planes, seeds, params, *a, **k)
        t = time.perf_counter()
        _, B, Ps = src_planes.shape
        Pt = tgt_planes.shape[2]
        pts = ((out[:, 11].double() + 1.0) * (src_planes[2] > 0.5).sum(1).double()
               * (tgt_planes[0] < 5e3).sum(1).double()).sum()
        ops, nbytes = peaks.k1_work(B, Ps, Pt, 1.0, params.icp_use_reciprocal_correspondences)
        t_ops = pts * (ops / peaks.PEAK_FP32_INSTR)
        t_bytes = nbytes / peaks.PEAK_BYTES
        c = rec.counters
        c["k1_least_s"] = c.get("k1_least_s", 0.0) + torch.clamp(t_ops, min=t_bytes)
        c["k1_ops_bound"] = c.get("k1_ops_bound", 0) + (t_ops >= t_bytes).int()
        c["k1_launches"] = c.get("k1_launches", 0) + 1
        rec.instrument_s += time.perf_counter() - t
        return out
    return call


def read(rec):
    kernels = [e - s for s, e, n, _ in rec.trace.ops if KERNEL in n]
    launches = rec.counters.get("k1_launches", 0)
    if not kernels or launches != len(kernels):
        rec.notes["k1_roofline"] = dict(counted_launches=launches, traced_launches=len(kernels))
        return None
    dev = sum(kernels) * 1e-9
    least = float(rec.counters["k1_least_s"])
    rec.notes["k1_roofline"] = dict(least_s=least, device_s=dev, launches=launches,
                                    bound_by_operations=int(rec.counters["k1_ops_bound"]))
    return 100.0 * least / dev
