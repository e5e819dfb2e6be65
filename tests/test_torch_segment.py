"""The ordered segment sum (dpg_slam_tpu_torch/graph/segment.py) and the
pose-graph assemblies built on it, against float ``index_add_``, whose
order of additions the segment sum keeps on the CPU.

Every comparison is to the bit (torch.equal): values (M, 3, 3) and (M, 3)
spread over 8 decades into fewer and into more rows than values (a
segment per row, a segment per value), rows no value goes to, values
dropped (bound for row n), all values into one row, no values, the prior / i / j contributions concatenated in
that order; and _assemble, _assemble_lanes, _matvec and _dense_H on the
bench_assets/session graph against copies of their index_add_ forms (the
port's code before the segment sum), with and without the Huber weights.
"""

import pathlib

import numpy as np
import pytest
import torch

from dpg_slam_tpu_torch import batch as tb
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.graph.segment import segment_plan, segment_sum
from dpg_slam_tpu_torch.utils.checkpoint import load_checkpoint

SESSION = pathlib.Path(__file__).resolve().parent.parent / "bench_assets" / "session"


def _values(rng, shape):
    return torch.from_numpy((rng.normal(size=shape) * 10.0 ** rng.uniform(-4, 4, size=shape)).astype(np.float32))


@pytest.mark.parametrize("n", [256, 100_000])  # a segment per row; a segment per value (rows > values)
@pytest.mark.parametrize("tail", [(3, 3), (3,)])
def test_segment_sum_matches_index_add(tail, n):
    rng = np.random.default_rng(3)
    vals = _values(rng, (4096,) + tail)
    idx = torch.from_numpy(rng.integers(0, n * 200 // 256, 4096))  # the last rows get nothing
    want = torch.zeros((n,) + tail).index_add_(0, idx, vals)
    plan = segment_plan(idx, n)
    assert (plan.rows is None) == (n <= 4096)
    got = segment_sum(vals, plan)
    assert torch.equal(got, want)
    assert not got[n * 200 // 256:].any()


@pytest.mark.parametrize("M", [0, 1, 100])
def test_segment_sum_one_row_and_no_values(M):
    vals = _values(np.random.default_rng(M), (M, 3))
    idx = torch.full((M,), 5)
    assert torch.equal(segment_sum(vals, segment_plan(idx, 8)), torch.zeros(8, 3).index_add_(0, idx, vals))


@pytest.mark.parametrize("n", [64, 100_000])
def test_segment_sum_drops_values_bound_for_row_n(n):
    """Values at destination n (the solves' masked slots) are dropped,
    whichever form the plan takes; every other row as index_add_ on n + 1
    rows gives it."""
    rng = np.random.default_rng(n)
    vals = _values(rng, (1000, 3, 3))
    idx = torch.from_numpy(np.where(rng.uniform(size=1000) < 0.4, n, rng.integers(0, min(n, 500), 1000)))
    want = torch.zeros((n + 1, 3, 3)).index_add_(0, idx, vals)[:n]
    assert torch.equal(segment_sum(vals, segment_plan(idx, n)), want)


def test_segment_sum_keeps_the_concatenated_order():
    """Three index_add_ calls (prior, i, j) against one sum of the three
    concatenated, and a sum that starts from a non-zero row (_matvec's
    diagonal product) against index_add on top of it."""
    rng = np.random.default_rng(4)
    parts = [(torch.from_numpy(rng.integers(0, 64, m)), _values(rng, (m, 3, 3))) for m in (8, 500, 500)]
    want = torch.zeros(64, 3, 3)
    for idx, vals in parts:
        want.index_add_(0, idx, vals)
    plan = segment_plan(torch.cat([i for i, _ in parts]), 64)
    assert torch.equal(segment_sum(torch.cat([v for _, v in parts]), plan), want)
    start = _values(rng, (64, 3, 3))
    want = start.clone()
    for idx, vals in parts[1:]:
        want = want.index_add(0, idx, vals)
    plan = segment_plan(torch.cat([torch.arange(64)] + [i for i, _ in parts[1:]]), 64)
    assert torch.equal(segment_sum(torch.cat([start] + [v for _, v in parts[1:]]), plan), want)


# --- the assemblies against their index_add_ forms ----------------------------

def _old_blocks(N_rows, p_idx, i_idx, j_idx, pJ, pr, Ji, Jj, er):
    diag = torch.zeros((N_rows, 3, 3))
    diag.index_add_(0, p_idx, pJ.transpose(-1, -2) @ pJ)
    diag.index_add_(0, i_idx, Ji.transpose(-1, -2) @ Ji)
    diag.index_add_(0, j_idx, Jj.transpose(-1, -2) @ Jj)
    rhs = torch.zeros((N_rows, 3))
    rhs.index_add_(0, p_idx, torch.einsum("pba,pb->pa", pJ, pr))
    rhs.index_add_(0, i_idx, torch.einsum("eba,eb->ea", Ji, er))
    rhs.index_add_(0, j_idx, torch.einsum("eba,eb->ea", Jj, er))
    return diag, rhs


def _old_assemble(poses, g, node_mask, robust_delta):
    N = poses.shape[0]
    pr, pJ = fg._prior_residual_jac(poses, g)
    er, Ji, Jj = fg._between_residual_jac(poses, g)
    pmask, emask = g.prior_mask, g.edge_mask
    pm, em = pmask.float(), emask.float()
    if robust_delta is not None:
        em = em * torch.sqrt(fg._huber_weight(er, robust_delta))
    pJ, pr = pJ * pm[:, None, None], pr * pm[:, None]
    Ji, Jj, er = Ji * em[:, None, None], Jj * em[:, None, None], er * em[:, None]
    diag, rhs = _old_blocks(N, fg._masked_index(g.prior_idx, pmask), fg._masked_index(g.edge_idx[:, 0], emask),
                            fg._masked_index(g.edge_idx[:, 1], emask), pJ, pr, Ji, Jj, er)
    diag = torch.where(node_mask[:, None, None], diag, torch.eye(3))
    rhs = torch.where(node_mask[:, None], rhs, 0.0)
    return diag, Ji.transpose(-1, -2) @ Jj, rhs


def _old_assemble_lanes(poses, g, node_mask, robust_delta):
    S, N = poses.shape[:2]
    pmask, emask = g.prior_mask, g.edge_mask
    base = (torch.arange(S) * N)[:, None]
    p_idx = (fg._masked_index(g.prior_idx, pmask) + base).reshape(-1)
    i_idx = (fg._masked_index(g.edge_idx[..., 0], emask) + base).reshape(-1)
    j_idx = (fg._masked_index(g.edge_idx[..., 1], emask) + base).reshape(-1)
    flat = poses.reshape(S * N, 3)
    pr, pJ = fg._prior_rj(flat[p_idx], g.prior_val.reshape(-1, 3), g.prior_sqrt_info.reshape(-1, 3, 3))
    er, Ji, Jj = fg._between_rj(flat[i_idx], flat[j_idx], g.edge_meas.reshape(-1, 3), g.edge_sqrt_info.reshape(-1, 3, 3))
    pm, em = pmask.reshape(-1).float(), emask.reshape(-1).float()
    if robust_delta is not None:
        em = em * torch.sqrt(fg._huber_weight(er, robust_delta))
    pJ, pr = pJ * pm[:, None, None], pr * pm[:, None]
    Ji, Jj, er = Ji * em[:, None, None], Jj * em[:, None, None], er * em[:, None]
    diag, rhs = _old_blocks(S * N, p_idx, i_idx, j_idx, pJ, pr, Ji, Jj, er)
    live = node_mask.reshape(-1)
    diag = torch.where(live[:, None, None], diag, torch.eye(3))
    rhs = torch.where(live[:, None], rhs, 0.0)
    return diag.view(S, N, 3, 3), (Ji.transpose(-1, -2) @ Jj).view(S, -1, 3, 3), rhs.view(S, N, 3)


def _old_matvec(eq, g, v):
    emask = g.edge_mask
    i_idx = fg._masked_index(g.edge_idx[:, 0], emask)
    j_idx = fg._masked_index(g.edge_idx[:, 1], emask)
    em = emask.float()[:, None]
    out = torch.einsum("nab,nb->na", eq.diag, v)
    out = out.index_add(0, i_idx, em * torch.einsum("eab,eb->ea", eq.off, v[j_idx]))
    return out.index_add(0, j_idx, em * torch.einsum("eba,eb->ea", eq.off, v[i_idx]))


def _old_dense_H(eq, g, damping):
    lanes = eq.diag.ndim == 4
    S = eq.diag.shape[0] if lanes else 1
    N = eq.diag.shape[-3]
    emask = g.edge_mask
    i_idx = fg._masked_index(g.edge_idx[..., 0], emask).reshape(S, -1)
    j_idx = fg._masked_index(g.edge_idx[..., 1], emask).reshape(S, -1)
    offm = (emask.float()[..., None, None] * eq.off).reshape(-1, 3, 3)
    d = damping[:, None, None, None] if lanes else damping
    base = (torch.arange(S) * (N * N))[:, None]
    H = torch.zeros((S * N * N, 3, 3))
    H.index_add_(0, (base + torch.arange(N) * (N + 1)).reshape(-1), (eq.diag + d * torch.eye(3)).reshape(-1, 3, 3))
    H.index_add_(0, (base + i_idx * N + j_idx).reshape(-1), offm)
    H.index_add_(0, (base + j_idx * N + i_idx).reshape(-1), offm.transpose(-1, -2))
    H = H.view(S, N, N, 3, 3).permute(0, 1, 3, 2, 4).reshape(S, 3 * N, 3 * N)
    return H if lanes else H[0]


@pytest.fixture(scope="module")
def session():
    """bench_assets/session's graph at perturbed poses; and a two-lane
    stack of it, the second lane with half the edges live."""
    st = load_checkpoint(SESSION, "cpu").state
    g = st.graph
    rng = np.random.default_rng(5)
    poses = st.poses + torch.from_numpy(rng.normal(0, 0.05, st.poses.shape).astype(np.float32)) * st.node_mask[:, None]
    lanes = tb._tree_map(lambda x: torch.stack([x, x]), st).graph
    lanes = lanes._replace(num_edges=torch.stack([g.num_edges, g.num_edges // 2]))
    lane_poses = torch.stack([poses, st.poses])
    lane_mask = st.node_mask.expand(2, -1)
    # The (i, j) keys of _dense_H must repeat here, or the test would not
    # exercise the sum's order.
    n = int(g.num_edges)
    keys = g.edge_idx[:n, 0].long() * poses.shape[0] + g.edge_idx[:n, 1].long()
    assert keys.unique().numel() < n
    return g, poses, st.node_mask, lanes, lane_poses, lane_mask


@pytest.mark.parametrize("robust_delta", [None, 2.0])
def test_assemble_matches_index_add_form(session, robust_delta):
    g, poses, mask, *_ = session
    eq, _ = fg._assemble(poses, g, mask, robust_delta)
    for got, want in zip(eq, _old_assemble(poses, g, mask, robust_delta)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("robust_delta", [None, 2.0])
def test_assemble_lanes_matches_index_add_form(session, robust_delta):
    *_, lanes, lane_poses, lane_mask = session
    eq, _ = fg._assemble_lanes(lane_poses, lanes, lane_mask, robust_delta)
    for got, want in zip(eq, _old_assemble_lanes(lane_poses, lanes, lane_mask, robust_delta)):
        assert torch.equal(got, want)


def test_matvec_matches_index_add_form(session):
    g, poses, mask, *_ = session
    eq, _ = fg._assemble(poses, g, mask, 2.0)
    v = torch.from_numpy(np.random.default_rng(6).normal(size=poses.shape).astype(np.float32))
    assert torch.equal(fg._matvec(eq, g, v), _old_matvec(eq, g, v))
    assert torch.equal(fg._matvec(eq, g, v, fg._matvec_plan(g, poses.shape[0])), _old_matvec(eq, g, v))


def test_dense_H_matches_index_add_form(session):
    g, poses, mask, lanes, lane_poses, lane_mask = session
    eq, _ = fg._assemble(poses, g, mask, 2.0)
    damping = torch.tensor(1e-3)
    assert torch.equal(fg._dense_H(eq, g, damping), _old_dense_H(eq, g, damping))
    assert torch.equal(fg._dense_H(eq, g, damping, fg._dense_plan(g, poses.shape[0])), _old_dense_H(eq, g, damping))
    leq, _ = fg._assemble_lanes(lane_poses, lanes, lane_mask, 2.0)
    ldamp = torch.tensor([1e-3, 4e-3])
    assert torch.equal(fg._dense_H(leq, lanes, ldamp), _old_dense_H(leq, lanes, ldamp))
