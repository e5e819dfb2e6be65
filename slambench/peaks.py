"""The card's published peaks and the least time of a kernel's work: the
benchmark's copy of chip_smoke.py's ``bound`` and ``k1_bound``.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): FP32 outside the tensor cores 67 TFLOP/s (an FMA counted as two
operations), HBM3 3.35 TB/s, and the FP32 instruction rate, 128 lanes x
132 SMs x 1.98 GHz boost: K1's distance arithmetic has no FMA (its d2
helper forbids contraction), so each of its operations is one
instruction.
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_FP32_INSTR = 128 * 132 * 1.98e9


def bound(ops: float, nbytes: float, rate: float = PEAK_FP32) -> tuple[float, str]:
    """(least seconds, what bounds it): `ops` at `rate` a second against
    `nbytes` at HBM bandwidth."""
    t_ops, t_bytes = ops / rate, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_work(B: int, Ps: int, Pt: int, pair_points: float, reciprocal: bool) -> tuple[float, float]:
    """(operations, bytes) of K1 on B pairs of Ps sources against Pt
    targets, where pair_points is the sum over pairs of (iterations + 1
    final pass) x valid sources x valid targets: each point pair costs 7
    operations (the distance: 2 sub, 2 mul, add; a compare against the
    source's running min; a min into the target's column min, with
    reciprocal matching; 6 without). Bytes: the 3 source and 4 target
    planes, the 4-float seeds and the 24-float output rows, each read or
    written once."""
    per = 6 + (1 if reciprocal else 0)
    return pair_points * per, 4.0 * (3 * B * Ps + 4 * B * Pt + 4 * B + 24 * B)


def k1_bound(B: int, Ps: int, Pt: int, pair_points: float, reciprocal: bool) -> tuple[float, str]:
    """K1's least seconds on one launch or a sum of launches."""
    ops, nbytes = k1_work(B, Ps, Pt, pair_points, reciprocal)
    return bound(ops, nbytes, PEAK_FP32_INSTR)
