"""SE(2) pose-graph optimization on tensors — the port of
dpg_slam_tpu/graph/factor_graph.py.

A FactorGraph is a NamedTuple of fixed-capacity factor tensors plus live
counts (0-dim int32 tensors); slots at or beyond a count are masked out.
Normal equations are assembled in block form with ordered segment sums
(graph/segment.py: each row adds its contributions in one fixed order, so
runs on the card repeat to the bit, as the JAX package's one-hot
contractions do; on the CPU the sums equal ``index_add_``'s). The factor
indices are fixed for a whole solve, so each solve sorts them once (a
SegmentPlan) and every assembly, matvec and dense H of the solve reuses
the sort. The LM solver is a Python loop that reads its accept/stop
decisions on the host.

``method="dense_pallas"`` solves the dense system with ops/schur.spd_solve
(kernel K2 on a CUDA tensor). ``solve_batched`` runs S graphs stacked on
a leading lane axis (batch.py's solver): one flat segment sum over the
S·N node slots per block kind and assembly, and accept/stop decisions kept
as per-lane device masks, so it never reads the host. ``solve_lanes`` is
``solve`` on such a stack with the JAX package's vmapped semantics (the
pass boundary's solver): every lane stops on its own rules, and the loop
reads the host once an iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.graph.segment import SegmentPlan, segment_plan, segment_sum
from dpg_slam_tpu_torch.utils import profiling
from dpg_slam_tpu_torch.ops import schur

__all__ = [
    "FactorGraph",
    "SolveStats",
    "empty_graph",
    "sqrt_info_from_sigmas",
    "sqrt_info_from_covariance",
    "add_prior",
    "add_between",
    "add_between_batch",
    "residuals",
    "total_error",
    "solve",
    "solve_batched",
    "solve_lanes",
]


class FactorGraph(NamedTuple):
    """Fixed-capacity factor tensors; node poses live outside the graph."""

    prior_idx: torch.Tensor        # (P,) int32 node index
    prior_val: torch.Tensor        # (P, 3) prior pose
    prior_sqrt_info: torch.Tensor  # (P, 3, 3) whitening matrix
    num_priors: torch.Tensor       # () int32
    edge_idx: torch.Tensor         # (E, 2) int32 [from, to]
    edge_meas: torch.Tensor        # (E, 3) measured pose of `to` in `from`'s frame
    edge_sqrt_info: torch.Tensor   # (E, 3, 3)
    num_edges: torch.Tensor        # () int32

    # Live-slot masks, (P,) / (E,), or (S, P) / (S, E) for a graph stacked
    # on a leading lane axis.
    @property
    def prior_mask(self) -> torch.Tensor:
        return torch.arange(self.prior_idx.shape[-1], device=self.prior_idx.device) < self.num_priors[..., None]

    @property
    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.edge_idx.shape[-2], device=self.edge_idx.device) < self.num_edges[..., None]


class SolveStats(NamedTuple):
    initial_error: torch.Tensor  # ()
    final_error: torch.Tensor    # ()
    iterations: int              # accepted LM steps


def empty_graph(max_priors: int, max_edges: int, device="cuda") -> FactorGraph:
    f32, i32 = torch.float32, torch.int32
    return FactorGraph(
        prior_idx=torch.zeros((max_priors,), dtype=i32, device=device),
        prior_val=torch.zeros((max_priors, 3), dtype=f32, device=device),
        prior_sqrt_info=torch.zeros((max_priors, 3, 3), dtype=f32, device=device),
        num_priors=torch.zeros((), dtype=i32, device=device),
        edge_idx=torch.zeros((max_edges, 2), dtype=i32, device=device),
        edge_meas=torch.zeros((max_edges, 3), dtype=f32, device=device),
        edge_sqrt_info=torch.zeros((max_edges, 3, 3), dtype=f32, device=device),
        num_edges=torch.zeros((), dtype=i32, device=device),
    )


def sqrt_info_from_sigmas(sigmas: torch.Tensor) -> torch.Tensor:
    """Diagonal sqrt-information from (..., 3) standard deviations."""
    return torch.diag_embed(1.0 / sigmas)


def sqrt_info_from_covariance(cov: torch.Tensor) -> torch.Tensor:
    """Whitening R = L^-1 with R^T R = cov^-1, closed form for (..., 3, 3)
    SE(2) covariances (noiseModel::Gaussian::Covariance analog)."""
    a11 = torch.clamp(cov[..., 0, 0], min=1e-18)
    a21 = cov[..., 1, 0]
    a31 = cov[..., 2, 0]
    a22 = cov[..., 1, 1]
    a32 = cov[..., 2, 1]
    a33 = cov[..., 2, 2]
    l11 = torch.sqrt(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=1e-18))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=1e-18))
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l22 * l31) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    zero = torch.zeros_like(m11)
    return torch.stack(
        [
            torch.stack([m11, zero, zero], dim=-1),
            torch.stack([m21, m22, zero], dim=-1),
            torch.stack([m31, m32, m33], dim=-1),
        ],
        dim=-2,
    )


def _set_rows(t: torch.Tensor, rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    out[rows] = values.to(t.dtype)
    return out


def add_prior(g: FactorGraph, node: int, value: torch.Tensor, sqrt_info: torch.Tensor) -> FactorGraph:
    """Append a prior factor (capacity is checked by the caller)."""
    i = g.num_priors.long()
    return g._replace(
        prior_idx=_set_rows(g.prior_idx, i, torch.as_tensor(node, device=i.device)),
        prior_val=_set_rows(g.prior_val, i, value),
        prior_sqrt_info=_set_rows(g.prior_sqrt_info, i, sqrt_info),
        num_priors=g.num_priors + 1,
    )


def add_between_batch(
    g: FactorGraph,
    from_idx: torch.Tensor,   # (M,)
    to_idx: torch.Tensor,     # (M,)
    meas: torch.Tensor,       # (M, 3)
    sqrt_info: torch.Tensor,  # (M, 3, 3)
    valid: torch.Tensor,      # (M,) bool — invalid rows consume no slot
) -> FactorGraph:
    """Append M between factors, packed into consecutive slots in row
    order (the same packing as M sequential add_between calls). Rows that
    would land beyond capacity are dropped, as XLA's mode="drop"
    scatter drops them; the count still grows by the number of valid rows."""
    vi = valid.to(torch.int32)
    slots = g.num_edges + torch.cumsum(vi, 0) - vi
    keep = valid & (slots < g.edge_idx.shape[0])
    rows = slots[keep].long()
    pair = torch.stack([from_idx, to_idx], dim=-1)
    return g._replace(
        edge_idx=_set_rows(g.edge_idx, rows, pair[keep]),
        edge_meas=_set_rows(g.edge_meas, rows, meas[keep]),
        edge_sqrt_info=_set_rows(g.edge_sqrt_info, rows, sqrt_info[keep]),
        num_edges=g.num_edges + vi.sum().to(torch.int32),
    )


def add_between(
    g: FactorGraph, from_node: int, to_node: int, meas: torch.Tensor,
    sqrt_info: torch.Tensor, valid: bool = True,
) -> FactorGraph:
    """Append one between factor; with ``valid=False`` no slot is used."""
    if not valid:
        return g
    dev = g.edge_idx.device
    return add_between_batch(
        g,
        torch.tensor([from_node], dtype=torch.int32, device=dev),
        torch.tensor([to_node], dtype=torch.int32, device=dev),
        meas[None],
        sqrt_info[None],
        torch.ones((1,), dtype=torch.bool, device=dev),
    )


# --------------------------------------------------------------------------
# Residuals and Jacobians
# --------------------------------------------------------------------------

def _masked_index(idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Indices with masked slots sent to node 0 (their contributions are
    exact zeros), so stale slot contents can never index out of range."""
    return torch.where(mask, idx, 0).long()


def _between_residual_jac(poses: torch.Tensor, g: FactorGraph):
    """Whitened residuals and Jacobians of all between factors:
    r = between(x_i, x_j) - meas (angle wrapped); (E, 3), (E, 3, 3) x 2."""
    emask = g.edge_mask
    xi = poses[_masked_index(g.edge_idx[:, 0], emask)]
    xj = poses[_masked_index(g.edge_idx[:, 1], emask)]
    return _between_rj(xi, xj, g.edge_meas, g.edge_sqrt_info)


def _between_rj(xi, xj, meas, W):
    """_between_residual_jac on gathered (M, 3) endpoint poses."""
    c = torch.cos(xi[:, 2])
    s = torch.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    px = c * dx + s * dy
    py = -s * dx + c * dy
    pth = geom.wrap_angle(xj[:, 2] - xi[:, 2])
    r = torch.stack([px, py, pth], dim=-1) - meas
    r = torch.cat([r[:, :2], geom.wrap_angle(r[:, 2:3])], dim=-1)

    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    Ji = torch.stack(
        [
            torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
            torch.stack([s, -c, -c * dx - s * dy], dim=-1),
            torch.stack([zeros, zeros, -ones], dim=-1),
        ],
        dim=-2,
    )
    Jj = torch.stack(
        [
            torch.stack([c, s, zeros], dim=-1),
            torch.stack([-s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return (
        torch.einsum("eab,eb->ea", W, r),
        torch.einsum("eab,ebc->eac", W, Ji),
        torch.einsum("eab,ebc->eac", W, Jj),
    )


def _prior_residual_jac(poses: torch.Tensor, g: FactorGraph):
    """Whitened residual and Jacobian of the priors: r = x - prior."""
    return _prior_rj(poses[_masked_index(g.prior_idx, g.prior_mask)], g.prior_val, g.prior_sqrt_info)


def _prior_rj(x, val, W):
    """_prior_residual_jac on gathered (M, 3) poses."""
    r = x - val
    r = torch.cat([r[:, :2], geom.wrap_angle(r[:, 2:3])], dim=-1)
    return torch.einsum("pab,pb->pa", W, r), W


def residuals(poses: torch.Tensor, g: FactorGraph) -> torch.Tensor:
    """All whitened residuals stacked: (P*3 + E*3,), masked slots zero."""
    pr, _ = _prior_residual_jac(poses, g)
    er, _, _ = _between_residual_jac(poses, g)
    pr = torch.where(g.prior_mask[:, None], pr, 0.0)
    er = torch.where(g.edge_mask[:, None], er, 0.0)
    return torch.cat([pr.reshape(-1), er.reshape(-1)])


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight per factor: 1 inside the delta band, delta/||r|| out."""
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.where(nrm <= delta, 1.0, delta / torch.clamp(nrm, min=1e-12))


def _huber_loss(r: torch.Tensor, delta: float) -> torch.Tensor:
    nrm = torch.linalg.norm(r, dim=-1)
    quad = 0.5 * nrm * nrm
    lin = delta * nrm - 0.5 * delta * delta
    return torch.sum(torch.where(nrm <= delta, quad, lin))


def _error_from_residuals(pr, er, robust_delta):
    prior_err = 0.5 * torch.sum(pr * pr)
    if robust_delta is None:
        return prior_err + 0.5 * torch.sum(er * er)
    return prior_err + _huber_loss(er, robust_delta)


def total_error(poses: torch.Tensor, g: FactorGraph, robust_delta: float | None = None) -> torch.Tensor:
    """Total graph error; Huber on between factors when robust_delta is set."""
    pr, _ = _prior_residual_jac(poses, g)
    er, _, _ = _between_residual_jac(poses, g)
    pr = torch.where(g.prior_mask[:, None], pr, 0.0)
    er = torch.where(g.edge_mask[:, None], er, 0.0)
    return _error_from_residuals(pr, er, robust_delta)


# --------------------------------------------------------------------------
# Normal equations
# --------------------------------------------------------------------------

class _NormalEq(NamedTuple):
    diag: torch.Tensor  # (N, 3, 3) diagonal blocks of H
    off: torch.Tensor   # (E, 3, 3) off-diagonal block (i, j) per edge
    rhs: torch.Tensor   # (N, 3) gradient J^T r


def _factor_rows(g: FactorGraph, N: int):
    """Flat node slot of every prior and of both ends of every edge, masked
    slots sent to node 0: (P,), (E,), (E,); for a graph stacked on a lane
    axis (S·P,), (S·E,), (S·E,) with lane s at offset s·N."""
    pmask, emask = g.prior_mask, g.edge_mask
    rows = (
        _masked_index(g.prior_idx, pmask),
        _masked_index(g.edge_idx[..., 0], emask),
        _masked_index(g.edge_idx[..., 1], emask),
    )
    if g.prior_idx.ndim == 2:
        base = (torch.arange(g.prior_idx.shape[0], device=g.prior_idx.device) * N)[:, None]
        rows = tuple(r + base for r in rows)
    return tuple(r.reshape(-1) for r in rows)


def _assemble_plan(g: FactorGraph, N: int) -> SegmentPlan:
    """The segment plan of the diagonal and gradient sums: prior, then
    `i`, then `j` contributions, over the (S·)N node slots; masked slots
    (exact zeros) are dropped."""
    S = g.prior_idx.shape[0] if g.prior_idx.ndim == 2 else 1
    p_idx, i_idx, j_idx = _factor_rows(g, N)
    pmask, emask = g.prior_mask.reshape(-1), g.edge_mask.reshape(-1)
    keys = torch.cat([torch.where(pmask, p_idx, S * N), torch.where(emask, i_idx, S * N),
                      torch.where(emask, j_idx, S * N)])
    return segment_plan(keys, S * N)


def _matvec_plan(g: FactorGraph, N: int) -> SegmentPlan:
    """The segment plan of _matvec: each node's diagonal product, then the
    `i` and `j` ends of the live edges (over the S·N node slots of a graph
    stacked on a lane axis, lane s at offset s·N)."""
    S = g.prior_idx.shape[0] if g.prior_idx.ndim == 2 else 1
    _, i_idx, j_idx = _factor_rows(g, N)
    emask = g.edge_mask.reshape(-1)
    return segment_plan(torch.cat([torch.arange(S * N, device=i_idx.device), torch.where(emask, i_idx, S * N),
                                   torch.where(emask, j_idx, S * N)]), S * N)


def _dense_plan(g: FactorGraph, N: int) -> SegmentPlan:
    """The segment plan of _dense_H over the S·N·N flat blocks (lane s at
    offset s·N·N): the diagonal blocks, then the (i, j) and the (j, i)
    block of every live edge. The (i, j) keys repeat where two factors
    join the same nodes (an odometry factor and a successive-scan
    factor)."""
    lanes = g.prior_idx.ndim == 2
    S = g.prior_idx.shape[0] if lanes else 1
    dev = g.prior_idx.device
    emask = g.edge_mask.reshape(S, -1)
    i_idx = g.edge_idx[..., 0].reshape(S, -1).long()
    j_idx = g.edge_idx[..., 1].reshape(S, -1).long()
    base = (torch.arange(S, device=dev) * (N * N))[:, None]
    keys = (base + torch.arange(N, device=dev) * (N + 1), torch.where(emask, base + i_idx * N + j_idx, S * N * N),
            torch.where(emask, base + j_idx * N + i_idx, S * N * N))
    return segment_plan(torch.cat([k.reshape(-1) for k in keys]), S * N * N)


def _assemble(
    poses: torch.Tensor, g: FactorGraph, node_mask: torch.Tensor,
    robust_delta: float | None = None, plan: SegmentPlan | None = None,
) -> tuple[_NormalEq, torch.Tensor]:
    """Normal equations and the total (robust) error in one residual sweep
    (plan: _assemble_plan(g, N), made here when not given)."""
    N = poses.shape[0]
    pr, pJ = _prior_residual_jac(poses, g)
    er, Ji, Jj = _between_residual_jac(poses, g)
    pmask, emask = g.prior_mask, g.edge_mask
    pm = pmask.to(poses.dtype)
    em = emask.to(poses.dtype)

    err = _error_from_residuals(pr * pm[:, None], er * em[:, None], robust_delta)

    if robust_delta is not None:
        # IRLS: sqrt(huber weight) scales each between-factor's rows.
        em = em * torch.sqrt(_huber_weight(er, robust_delta))
    pJ = pJ * pm[:, None, None]
    pr = pr * pm[:, None]
    Ji = Ji * em[:, None, None]
    Jj = Jj * em[:, None, None]
    er = er * em[:, None]

    diag, off, rhs = _normal_blocks(pJ, pr, Ji, Jj, er, plan or _assemble_plan(g, N))

    # Inactive node slots: identity diagonal, zero gradient -> zero update.
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    diag = torch.where(node_mask[:, None, None], diag, eye)
    rhs = torch.where(node_mask[:, None], rhs, 0.0)
    return _NormalEq(diag, off, rhs), err


def _normal_blocks(pJ, pr, Ji, Jj, er, plan: SegmentPlan):
    """The diagonal blocks, off-diagonal blocks and gradient from masked
    (and IRLS-weighted) Jacobians and residuals: the prior, `i` and `j`
    contributions in that order, one segment sum each for diag and rhs."""
    diag = segment_sum(torch.cat([pJ.transpose(-1, -2) @ pJ, Ji.transpose(-1, -2) @ Ji,
                                  Jj.transpose(-1, -2) @ Jj]), plan)
    rhs = segment_sum(torch.cat([torch.einsum("pba,pb->pa", pJ, pr), torch.einsum("eba,eb->ea", Ji, er),
                                 torch.einsum("eba,eb->ea", Jj, er)]), plan)
    return diag, Ji.transpose(-1, -2) @ Jj, rhs


def _matvec(eq: _NormalEq, g: FactorGraph, v: torch.Tensor, plan: SegmentPlan | None = None) -> torch.Tensor:
    """H v from the block form — O(E), no dense H (plan: _matvec_plan).
    v is (N, 3), or (S, N, 3) with eq and g stacked on a lane axis."""
    N = v.shape[-2]
    _, i_idx, j_idx = _factor_rows(g, N)
    em = g.edge_mask.reshape(-1).to(v.dtype)[:, None]
    vf, off = v.reshape(-1, 3), eq.off.reshape(-1, 3, 3)
    return segment_sum(torch.cat([
        torch.einsum("nab,nb->na", eq.diag.reshape(-1, 3, 3), vf),
        em * torch.einsum("eab,eb->ea", off, vf[j_idx]),
        em * torch.einsum("eba,eb->ea", off, vf[i_idx]),
    ]), plan or _matvec_plan(g, N)).view(v.shape)


def _dense_H(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, plan: SegmentPlan | None = None) -> torch.Tensor:
    """The damped (3N, 3N) normal matrix: every block summed at its flat
    (row * N + col) block index by one ordered segment sum (plan:
    _dense_plan; the diagonal keys are unique, the (i, j) keys repeat).
    With a leading lane axis (eq.diag (S, N, 3, 3), damping (S,), a
    stacked graph) it gives (S, 3N, 3N) from the same sum over S·N·N
    blocks, lane s at offset s·N·N."""
    lanes = eq.diag.ndim == 4
    S = eq.diag.shape[0] if lanes else 1
    N = eq.diag.shape[-3]
    dt = eq.diag.dtype
    offm = (g.edge_mask.to(dt)[..., None, None] * eq.off).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=dt, device=eq.diag.device)
    d = damping[:, None, None, None] if lanes else damping
    H = segment_sum(torch.cat([(eq.diag + d * eye).reshape(-1, 3, 3), offm, offm.transpose(-1, -2)]),
                    plan or _dense_plan(g, N))
    H = H.view(S, N, N, 3, 3).permute(0, 1, 3, 2, 4).reshape(S, 3 * N, 3 * N)
    return H if lanes else H[0]


def _dense_solve(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, plan: SegmentPlan | None = None) -> torch.Tensor:
    """Cholesky solve of the dense damped system. A failed factorization
    yields NaN (as XLA's cho_factor does), which the LM loop rejects."""
    N = eq.diag.shape[0]
    L, info = torch.linalg.cholesky_ex(_dense_H(eq, g, damping, plan))
    delta = torch.cholesky_solve(eq.rhs.reshape(3 * N, 1), L)[:, 0]
    delta = torch.where(info == 0, delta, float("nan"))
    return delta.reshape(N, 3)


def _dense_pallas_solve(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor,
                        plan: SegmentPlan | None = None) -> torch.Tensor:
    """_dense_solve through ops/schur.spd_solve (the panel-blocked SPD
    solve; kernel K2 on a CUDA tensor) with the gradient as the one
    right-hand side."""
    N = eq.diag.shape[0]
    delta = schur.spd_solve(_dense_H(eq, g, damping, plan), eq.rhs.reshape(3 * N, 1))[:, 0]
    return delta.reshape(N, 3)


def _dense_cg_solve(
    eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, iters: int, rel_tol: float = 1e-6,
    plan: SegmentPlan | None = None,
) -> torch.Tensor:
    """Block-Jacobi preconditioned CG with a dense (3N, 3N) matvec and a
    residual-norm stop."""
    Hf = _dense_H(eq, g, damping, plan)
    eye = torch.eye(3, dtype=eq.diag.dtype, device=eq.diag.device)
    Minv = geom.inv_sym3(eq.diag + damping * eye)

    def precond(v):
        return torch.einsum("nab,nb->na", Minv, v.reshape(-1, 3)).reshape(-1)

    b = eq.rhs.reshape(-1)
    b2 = torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    it = 0
    while it < iters and bool(torch.sum(r * r) > rel_tol * rel_tol * b2):
        Ap = Hf @ p
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x.reshape(-1, 3)


def _cg_solve(
    eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, iters: int, plan: SegmentPlan | None = None,
) -> torch.Tensor:
    """Block-Jacobi preconditioned CG on the block-sparse system, a fixed
    number of iterations (plan: _matvec_plan)."""
    plan = plan or _matvec_plan(g, eq.diag.shape[0])
    eye = torch.eye(3, dtype=eq.diag.dtype, device=eq.diag.device)
    diag_d = eq.diag + damping * eye
    eqd = _NormalEq(diag_d, eq.off, eq.rhs)
    Minv = geom.inv_sym3(diag_d)

    def precond(v):
        return torch.einsum("nab,nb->na", Minv, v)

    b = eq.rhs
    x = torch.zeros_like(b)
    r = b - _matvec(eqd, g, x, plan)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = _matvec(eqd, g, p, plan)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x


# --------------------------------------------------------------------------
# LM solver
# --------------------------------------------------------------------------

def solve(
    poses: torch.Tensor,
    g: FactorGraph,
    node_mask: torch.Tensor,
    *,
    max_iterations: int = 20,
    damping_init: float = 1e-4,
    method: str = "dense",
    cg_iterations: int = 64,
    robust_delta: float | None = None,
    gradient_tol: float = 0.0,
    terminate_on_reject: bool = False,
    rel_tol: float = 1e-6,
) -> tuple[torch.Tensor, SolveStats]:
    """Levenberg-Marquardt over the pose graph (the JAX package's solve,
    with its while_loop as a Python loop).

    method: "dense" (Cholesky), "dense_pallas" (the blocked SPD solve of
    ops/schur, kernel K2 on the card), "dense_cg" (dense-matvec PCG) or
    "cg" (block-sparse PCG). Accept when the error drops; damping x0.5 on
    accept, x4 on reject, clipped to [1e-9, 1e6]. gradient_tol skips or
    stops when the max-abs gradient is below it; terminate_on_reject stops
    on a rejection after one first-step damping retry (warm solves).
    """
    if method not in ("dense", "dense_pallas", "dense_cg", "cg"):
        raise ValueError(f"unknown solve method {method!r}")
    N = poses.shape[0]
    aplan = _assemble_plan(g, N)
    splan = _matvec_plan(g, N) if method == "cg" else _dense_plan(g, N)
    eq, err0 = _assemble(poses, g, node_mask, robust_delta, aplan)
    gnorm = float(eq.rhs.abs().max())
    err = err0
    damping = torch.tensor(damping_init, dtype=poses.dtype, device=poses.device)
    accepted = 0
    it = 0
    done = False
    while it < max_iterations and not done and gnorm > gradient_tol:
        if method == "dense":
            delta = _dense_solve(eq, g, damping, splan)
        elif method == "dense_pallas":
            delta = _dense_pallas_solve(eq, g, damping, splan)
        elif method == "dense_cg":
            delta = _dense_cg_solve(eq, g, damping, cg_iterations, plan=splan)
        else:
            delta = _cg_solve(eq, g, damping, cg_iterations, splan)
        new_poses = poses - delta
        new_poses = torch.cat([new_poses[:, :2], geom.wrap_angle(new_poses[:, 2:3])], dim=-1)
        new_err = total_error(new_poses, g, robust_delta)
        accept = bool(new_err < err)
        small = bool((err - new_err) / torch.clamp(err, min=1e-12) < rel_tol)
        if terminate_on_reject:
            # Stop on a tiny accept or a reject, but give a first-step
            # rejection one damping retry (it can be an overshoot).
            done = small and (accept or accepted > 0 or it >= 1)
        else:
            done = accept and small
        if accept:
            poses, err = new_poses, new_err
            # Re-linearize only when the loop continues from here.
            if not done and it + 1 < max_iterations:
                eq, _ = _assemble(poses, g, node_mask, robust_delta, aplan)
                gnorm = float(eq.rhs.abs().max())
        damping = torch.clamp(damping * (0.5 if accept else 4.0), 1e-9, 1e6)
        accepted += int(accept)
        it += 1
    return poses, SolveStats(initial_error=err0, final_error=err, iterations=accepted)


# --------------------------------------------------------------------------
# Lane-batched LM (the session-batched mode's solver)
# --------------------------------------------------------------------------

def _lane_error(pr: torch.Tensor, er: torch.Tensor, robust_delta: float | None) -> torch.Tensor:
    """_error_from_residuals per lane: (S, P, 3), (S, E, 3) -> (S,)."""
    prior_err = 0.5 * torch.sum(pr * pr, dim=(1, 2))
    if robust_delta is None:
        return prior_err + 0.5 * torch.sum(er * er, dim=(1, 2))
    nrm = torch.linalg.norm(er, dim=-1)
    huber = torch.where(nrm <= robust_delta, 0.5 * nrm * nrm, robust_delta * nrm - 0.5 * robust_delta * robust_delta)
    return prior_err + torch.sum(huber, dim=1)


def _assemble_lanes(
    poses: torch.Tensor, g: FactorGraph, node_mask: torch.Tensor,
    robust_delta: float | None = None, plan: SegmentPlan | None = None,
) -> tuple[_NormalEq, torch.Tensor]:
    """_assemble for S graphs stacked on a leading lane axis: poses
    (S, N, 3), node_mask (S, N). The factors of every lane go through one
    residual sweep and one flat segment sum per block kind over the S·N
    node slots (lane s at offset s·N; plan: _assemble_plan). Returns (eq
    with (S, N, 3, 3), (S, E, 3, 3), (S, N, 3) blocks, error (S,))."""
    with profiling.span("graph.assemble"):
        S, N = poses.shape[:2]
        P, E = g.prior_idx.shape[1], g.edge_idx.shape[1]
        dt, dev = poses.dtype, poses.device
        pmask, emask = g.prior_mask, g.edge_mask
        p_idx, i_idx, j_idx = _factor_rows(g, N)
        flat = poses.reshape(S * N, 3)
        pr, pJ = _prior_rj(flat[p_idx], g.prior_val.reshape(-1, 3), g.prior_sqrt_info.reshape(-1, 3, 3))
        er, Ji, Jj = _between_rj(flat[i_idx], flat[j_idx], g.edge_meas.reshape(-1, 3),
                                 g.edge_sqrt_info.reshape(-1, 3, 3))
        pm = pmask.reshape(-1).to(dt)
        em = emask.reshape(-1).to(dt)

        err = _lane_error((pr * pm[:, None]).view(S, P, 3), (er * em[:, None]).view(S, E, 3), robust_delta)

        if robust_delta is not None:
            em = em * torch.sqrt(_huber_weight(er, robust_delta))
        pJ = pJ * pm[:, None, None]
        pr = pr * pm[:, None]
        Ji = Ji * em[:, None, None]
        Jj = Jj * em[:, None, None]
        er = er * em[:, None]

        diag, off, rhs = _normal_blocks(pJ, pr, Ji, Jj, er, plan or _assemble_plan(g, N))

        live = node_mask.reshape(-1)
        eye = torch.eye(3, dtype=dt, device=dev)
        diag = torch.where(live[:, None, None], diag, eye)
        rhs = torch.where(live[:, None], rhs, 0.0)
        return _NormalEq(diag.view(S, N, 3, 3), off.view(S, E, 3, 3), rhs.view(S, N, 3)), err


def _dense_solve_lanes(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor,
                       plan: SegmentPlan | None = None, lanes=None) -> torch.Tensor:
    """_dense_solve for every lane of the (S, 3N, 3N) damped systems, or
    for the lanes listed in `lanes` (host ints; the others get a zero
    step); a lane whose factorization failed gets NaN, which its LM step
    rejects.

    The systems are factored one lane at a time: on an H100 the batched
    cholesky_ex of the session-batched mode's (16, 384, 384) systems
    reported failed factorizations on ~2 of 16 lanes a call, lanes that
    factor alone, and left lanes of 0.2-0.9 m ATE (chip_smoke.py phase 9,
    PERF.md)."""
    S, N = eq.diag.shape[:2]
    H = _dense_H(eq, g, damping, plan)
    b = eq.rhs.reshape(S, 3 * N, 1)
    if lanes is None:
        lanes = range(S)
    profiling.count("graph.factorizations", len(lanes))
    deltas = torch.zeros_like(b)
    for s in lanes:
        L, info = torch.linalg.cholesky_ex(H[s])
        deltas[s] = torch.where(info == 0, torch.cholesky_solve(b[s], L), float("nan"))
    return deltas.reshape(S, N, 3)


def _dense_cg_fixed(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, iters: int,
                    plan: SegmentPlan | None = None) -> torch.Tensor:
    """Block-Jacobi preconditioned CG on the dense (S, 3N, 3N) systems, a
    fixed number of iterations for every lane (no convergence test)."""
    S, N = eq.diag.shape[:2]
    Hf = _dense_H(eq, g, damping, plan)
    eye = torch.eye(3, dtype=eq.diag.dtype, device=eq.diag.device)
    Minv = geom.inv_sym3(eq.diag + damping[:, None, None, None] * eye)

    def precond(v):
        return torch.einsum("snab,snb->sna", Minv, v)

    def mv(v):
        return (Hf @ v.reshape(S, 3 * N, 1)).reshape(S, N, 3)

    b = eq.rhs
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=(1, 2))
    for _ in range(iters):
        Ap = mv(p)
        denom = torch.sum(p * Ap, dim=(1, 2))
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)[:, None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z, dim=(1, 2))
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)[:, None, None]
        p = z + beta * p
        rz = rz_new
    return x


def solve_batched(
    poses: torch.Tensor,
    g: FactorGraph,
    node_mask: torch.Tensor,
    *,
    max_iterations: int = 5,
    damping_init: float = 1e-4,
    method: str = "cg_fixed",
    cg_iterations: int = 8,
    robust_delta: float | None = None,
    gradient_tol: float = 0.0,
    terminate_on_reject: bool = False,
    rel_tol: float = 1e-6,
) -> tuple[torch.Tensor, SolveStats]:
    """LM over S independent pose graphs stacked on a leading lane axis:
    poses (S, N, 3), node_mask (S, N), graph leaves (S, ...).

    solve's update rules (accept on a lower error, damping x0.5 / x4 in
    [1e-9, 1e6], rel_tol stop, terminate_on_reject's first-step retry,
    gradient_tol) per lane, over max_iterations unrolled steps with
    per-lane accept / damping / done masks: a done lane's poses freeze as
    if its loop had exited. Each step assembles once at the candidate
    poses, which is both the accept test and the next linearization; a
    rejected lane keeps its previous one. No decision reads the host.

    method: "chol" (batched Cholesky) or "cg_fixed" (block-Jacobi PCG on
    the dense systems, cg_iterations each step). SolveStats holds (S,)
    tensors.
    """
    with profiling.span("graph.solve_batched"):
        if method not in ("chol", "cg_fixed"):
            raise ValueError(f"unknown batched solve method {method!r}")
        S, N = poses.shape[:2]
        aplan, dplan = _assemble_plan(g, N), _dense_plan(g, N)
        eq, err = _assemble_lanes(poses, g, node_mask, robust_delta, aplan)
        dev = poses.device
        damping = torch.full((S,), damping_init, dtype=poses.dtype, device=dev)
        if gradient_tol > 0.0:
            done = eq.rhs.abs().amax(dim=(1, 2)) <= gradient_tol
        else:
            done = torch.zeros((S,), dtype=torch.bool, device=dev)
        accepted = torch.zeros((S,), dtype=torch.int32, device=dev)
        err0 = err
        for it in range(max_iterations):
            profiling.count("graph.lm_iterations")
            with profiling.span("graph.factor"):
                if method == "chol":
                    delta = _dense_solve_lanes(eq, g, damping, dplan)
                else:
                    delta = _dense_cg_fixed(eq, g, damping, cg_iterations, dplan)
            cand = poses - delta
            cand = torch.cat([cand[..., :2], geom.wrap_angle(cand[..., 2:3])], dim=-1)
            eq_c, err_c = _assemble_lanes(cand, g, node_mask, robust_delta, aplan)
            accept = (err_c < err) & ~done
            small = (err - err_c) / torch.clamp(err, min=1e-12) < rel_tol
            if terminate_on_reject:
                new_done = small & (accept | (accepted > 0) | (it >= 1))
            else:
                new_done = accept & small
            poses = torch.where(accept[:, None, None], cand, poses)
            err = torch.where(accept, err_c, err)
            eq = _NormalEq(*(
                torch.where(accept.view((S,) + (1,) * (a.ndim - 1)), a, b) for a, b in zip(eq_c, eq)
            ))
            if gradient_tol > 0.0:
                new_done = new_done | (accept & (eq_c.rhs.abs().amax(dim=(1, 2)) <= gradient_tol))
            step = torch.where(accept, damping * 0.5, damping * 4.0)
            damping = torch.where(done, damping, torch.clamp(step, 1e-9, 1e6))
            accepted = accepted + (accept & ~done).to(torch.int32)
            done = done | new_done
        return poses, SolveStats(initial_error=err0, final_error=err, iterations=accepted)


# --------------------------------------------------------------------------
# The LM solve on a lane axis (fg.solve under jax.vmap)
# --------------------------------------------------------------------------

def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product of (S, ...) tensors: (S,)."""
    return torch.sum(a * b, dim=tuple(range(1, a.ndim)))


def _lane_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with an (S,) lane mask broadcast over a's trailing dims."""
    return torch.where(mask.view((-1,) + (1,) * (a.ndim - 1)), a, b)


def _dense_cg_solve_lanes(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, iters: int, live: torch.Tensor,
                          rel_tol: float = 1e-6, plan: SegmentPlan | None = None) -> torch.Tensor:
    """_dense_cg_solve for every lane of the (S, 3N, 3N) systems, as under
    jax.vmap: a lane iterates while its residual is above the stop and
    `iters` is not reached, and a stopped lane (or one not `live`) keeps its
    values. One host read a CG iteration: which lanes still iterate. Their
    dense matvecs run one lane at a time (a batched matmul would round
    otherwise than _dense_cg_solve's), the rest on all lanes at once."""
    S, N = eq.diag.shape[:2]
    Hf = _dense_H(eq, g, damping, plan)
    eye = torch.eye(3, dtype=eq.diag.dtype, device=eq.diag.device)
    Minv = geom.inv_sym3(eq.diag + damping[:, None, None, None] * eye)

    def precond(v):
        return torch.einsum("snab,snb->sna", Minv, v.view(S, N, 3)).reshape(S, -1)

    b = eq.rhs.reshape(S, -1)
    b2 = _lane_dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _lane_dot(r, z)
    it = 0
    while it < iters:
        active = live & (_lane_dot(r, r) > rel_tol * rel_tol * b2)
        active_h = active.cpu()
        profiling.count("host.reads")
        if not bool(active_h.any()):
            break
        Ap = torch.zeros_like(p)
        for s in torch.nonzero(active_h)[:, 0].tolist():
            Ap[s] = Hf[s] @ p[s]
        denom = _lane_dot(p, Ap)
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)[:, None]
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_new = _lane_dot(r_n, z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)[:, None]
        p_n = z + beta * p
        x, r, p = (_lane_where(active, n, o) for n, o in ((x_n, x), (r_n, r), (p_n, p)))
        rz = torch.where(active, rz_new, rz)
        live = active
        it += 1
    return x.reshape(S, N, 3)


def _cg_solve_lanes(eq: _NormalEq, g: FactorGraph, damping: torch.Tensor, iters: int,
                    plan: SegmentPlan | None = None) -> torch.Tensor:
    """_cg_solve for every lane (a fixed count, as JAX's scan: no stop to
    freeze on); the block-sparse matvec over the S·N node slots."""
    S, N = eq.diag.shape[:2]
    plan = plan or _matvec_plan(g, N)
    eye = torch.eye(3, dtype=eq.diag.dtype, device=eq.diag.device)
    diag_d = eq.diag + damping[:, None, None, None] * eye
    eqd = _NormalEq(diag_d, eq.off, eq.rhs)
    Minv = geom.inv_sym3(diag_d)

    def precond(v):
        return torch.einsum("snab,snb->sna", Minv, v)

    b = eq.rhs
    x = torch.zeros_like(b)
    r = b - _matvec(eqd, g, x, plan)
    z = precond(r)
    p = z
    rz = _lane_dot(r, z)
    for _ in range(iters):
        Ap = _matvec(eqd, g, p, plan)
        denom = _lane_dot(p, Ap)
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)[:, None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _lane_dot(r, z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)[:, None, None]
        p = z + beta * p
        rz = rz_new
    return x


def solve_lanes(
    poses: torch.Tensor,
    g: FactorGraph,
    node_mask: torch.Tensor,
    *,
    max_iterations: int = 20,
    damping_init: float = 1e-4,
    method: str = "dense",
    cg_iterations: int = 64,
    robust_delta: float | None = None,
    gradient_tol: float = 0.0,
    terminate_on_reject: bool = False,
    rel_tol: float = 1e-6,
) -> tuple[torch.Tensor, SolveStats]:
    """solve for S graphs stacked on a leading lane axis (poses (S, N, 3),
    node_mask (S, N), graph leaves (S, ...)), with the semantics of the
    JAX package's solve under jax.vmap: each lane has its own damping,
    error, accept flag and done flag, runs while it is not done, below
    max_iterations and above gradient_tol, and is frozen (poses, damping,
    error) once it stops, as a vmapped while_loop freezes it.

    The same methods as solve: "dense" factors the live lanes one at a
    time (_dense_solve_lanes), "dense_pallas" solves all S systems in one
    ops/schur.spd_solve call (one K2 launch on the card), "dense_cg" and
    "cg" run their CG on every lane at once. Each iteration assembles
    once, at the candidate poses: that sweep's error is the accept test
    and its normal equations the next linearization of an accepting lane.
    The loop reads the host once an iteration (which lanes are live), and
    "dense_cg" once more a CG iteration. SolveStats holds (S,) tensors.
    """
    with profiling.span("graph.solve_lanes"):
        if method not in ("dense", "dense_pallas", "dense_cg", "cg"):
            raise ValueError(f"unknown solve method {method!r}")
        S, N = poses.shape[:2]
        aplan = _assemble_plan(g, N)
        splan = _matvec_plan(g, N) if method == "cg" else _dense_plan(g, N)
        eq, err = _assemble_lanes(poses, g, node_mask, robust_delta, aplan)
        err0 = err
        gnorm = eq.rhs.abs().amax(dim=(1, 2))
        damping = torch.full((S,), damping_init, dtype=poses.dtype, device=poses.device)
        accepted = torch.zeros((S,), dtype=torch.int32, device=poses.device)
        done = torch.zeros((S,), dtype=torch.bool, device=poses.device)
        for it in range(max_iterations):
            live = ~done & (gnorm > gradient_tol)
            live_h = live.cpu()  # the iteration's one host read
            profiling.count("host.reads")
            if not bool(live_h.any()):
                break
            profiling.count("graph.lm_iterations")
            with profiling.span("graph.factor"):
                if method == "dense":
                    delta = _dense_solve_lanes(eq, g, damping, splan, lanes=torch.nonzero(live_h)[:, 0].tolist())
                elif method == "dense_pallas":
                    H = _dense_H(eq, g, damping, splan)
                    delta = schur.spd_solve(H, eq.rhs.reshape(S, 3 * N, 1)).reshape(S, N, 3)
                elif method == "dense_cg":
                    delta = _dense_cg_solve_lanes(eq, g, damping, cg_iterations, live, plan=splan)
                else:
                    delta = _cg_solve_lanes(eq, g, damping, cg_iterations, splan)
            cand = poses - delta
            cand = torch.cat([cand[..., :2], geom.wrap_angle(cand[..., 2:3])], dim=-1)
            eq_c, err_c = _assemble_lanes(cand, g, node_mask, robust_delta, aplan)
            accept = err_c < err
            small = (err - err_c) / torch.clamp(err, min=1e-12) < rel_tol
            if terminate_on_reject:
                stop = small & (accept | (accepted > 0) | (it >= 1))
            else:
                stop = accept & small
            take = accept & live
            poses = _lane_where(take, cand, poses)
            err = torch.where(take, err_c, err)
            eq = _NormalEq(*(_lane_where(take, a, b) for a, b in zip(eq_c, eq)))
            gnorm = torch.where(take, eq_c.rhs.abs().amax(dim=(1, 2)), gnorm)
            step = torch.clamp(damping * torch.where(accept, 0.5, 4.0), 1e-9, 1e6)
            damping = torch.where(live, step, damping)
            accepted = accepted + take.to(torch.int32)
            done = done | (live & stop)
        return poses, SolveStats(initial_error=err0, final_error=err, iterations=accepted)
