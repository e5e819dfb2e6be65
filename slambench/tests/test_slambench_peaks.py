"""The benchmark's copy of K1's bound gives chip_smoke.py's figures."""

import pytest
import torch

import chip_smoke
from dpg_slam_tpu_torch.config import PoseGraphParams
from slambench import peaks


@pytest.mark.parametrize("reciprocal", [True, False])
def test_k1_bound_equals_chip_smoke(reciprocal):
    g = torch.Generator().manual_seed(5)
    B, Ps, Pt = 37, 256, 2048
    src_mask = torch.rand((B, Ps), generator=g) < 0.8
    tgt_mask = torch.rand((B, Pt), generator=g) < 0.6
    out = torch.zeros((B, 24))
    out[:, 11] = torch.randint(0, 30, (B,), generator=g).float()
    pg = PoseGraphParams(icp_use_reciprocal_correspondences=reciprocal)
    want_ms, want_by = chip_smoke.k1_bound((None, src_mask, None, tgt_mask), out, pg)
    pts = float(((out[:, 11].double() + 1) * src_mask.sum(1).double() * tgt_mask.sum(1).double()).sum())
    got_s, got_by = peaks.k1_bound(B, Ps, Pt, pts, reciprocal)
    assert got_by == want_by
    assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert (peaks.PEAK_FP32, peaks.PEAK_BYTES, peaks.PEAK_FP32_INSTR) == (
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_BYTES, chip_smoke.PEAK_FP32_INSTR)


def test_bound_picks_the_larger_time():
    assert peaks.bound(67e12, 0.0) == (1.0, "operations")
    assert peaks.bound(0.0, 3.35e12) == (1.0, "bytes")
