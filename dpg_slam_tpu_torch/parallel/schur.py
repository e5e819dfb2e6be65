"""Distributed pose-graph solve by submap Schur-complement elimination —
the port of dpg_slam_tpu/parallel/schur.py.

The trajectory is partitioned into S submaps (shards). Each GN iteration
eliminates every shard's INTERIOR nodes with a dense Cholesky, reduces onto
the small SEPARATOR system (block boundaries and loop-closure endpoints),
sums the reduced systems over the shards, solves that replicated, and
back-substitutes the interiors. The JAX package runs the per-shard body
under ``shard_map`` with one ``psum``; here it runs batched over a leading
shard dimension (parallel/mesh.py) and the psum is a sum over it.

Factor routing: a factor with an interior endpoint belongs to the shard
owning that node; a factor between two separators to the shard of its
first endpoint; priors likewise. `separator_count` is returned so callers
can check that the cap held (overflowing separators are dropped from the
reduced system).

The interior elimination is ops/schur.spd_solve (kernel K2 on the card)
for all S shards in one call when ``pallas_elimination`` is set, else
torch.linalg's Cholesky, as the JAX package's XLA branch. The reduced
separator solve is torch.linalg in both.

The JAX package's out-of-range ``mode="drop"`` scatters become writes to
the padding row (interior slot C, separator slot sep_cap) of tensors that
have one, or boolean masks where they were indexed with N. The block sums
are ordered segment sums (graph/segment.py), so runs on the card repeat to
the bit.
"""

from __future__ import annotations

import torch

from dpg_slam_tpu_torch import geom
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.graph.segment import segment_plan, segment_sum
from dpg_slam_tpu_torch.ops import schur as schur_ops
from dpg_slam_tpu_torch.parallel.mesh import Mesh

__all__ = ["schur_solve"]


def full_graph(prior_idx, prior_val, prior_sqrt_info, prior_mask,
               edge_idx, edge_meas, edge_sqrt_info, edge_mask) -> fg.FactorGraph:
    """A FactorGraph over every slot, masked slots pointed at node 0, for
    callers that apply the (not necessarily prefix) masks themselves."""
    dev = edge_idx.device
    return fg.FactorGraph(
        prior_idx=torch.where(prior_mask, prior_idx, 0),
        prior_val=prior_val,
        prior_sqrt_info=prior_sqrt_info,
        num_priors=torch.tensor(prior_idx.shape[0], dtype=torch.int32, device=dev),
        edge_idx=torch.where(edge_mask[:, None], edge_idx, 0),
        edge_meas=edge_meas,
        edge_sqrt_info=edge_sqrt_info,
        num_edges=torch.tensor(edge_idx.shape[0], dtype=torch.int32, device=dev),
    )


def robust_between_error(er: torch.Tensor, robust_delta: float | None) -> torch.Tensor:
    """Between-factor error of masked whitened residuals (Huber when set)."""
    if robust_delta is None:
        return 0.5 * torch.sum(er * er)
    return fg._huber_loss(er, robust_delta)


def _blocks(A: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(S, R+1, Q+1, 3, 3) block tensor -> (S, 3 rows, 3 cols) matrix of its
    first rows x cols blocks (padding row and column dropped)."""
    S = A.shape[0]
    return A[:, :rows, :cols].permute(0, 1, 3, 2, 4).reshape(S, 3 * rows, 3 * cols)


def schur_solve(
    mesh: Mesh,
    poses: torch.Tensor,           # (N, 3)
    node_mask: torch.Tensor,       # (N,)
    prior_idx: torch.Tensor,       # (Pr,)
    prior_val: torch.Tensor,       # (Pr, 3)
    prior_sqrt_info: torch.Tensor, # (Pr, 3, 3)
    prior_mask: torch.Tensor,      # (Pr,)
    edge_idx: torch.Tensor,        # (E, 2)
    edge_meas: torch.Tensor,       # (E, 3)
    edge_sqrt_info: torch.Tensor,  # (E, 3, 3)
    edge_mask: torch.Tensor,       # (E,)
    block_assign: torch.Tensor | None = None,  # (N,) node -> shard
    *,
    sep_cap: int = 64,
    max_iterations: int = 10,
    damping: float = 1e-4,
    robust_delta: float | None = None,
    rel_tol: float = 0.0,
    pallas_elimination: bool = False,
):
    """Levenberg-Marquardt with per-iteration Schur elimination over the
    mesh's shards: Huber IRLS on between-factors when ``robust_delta`` is
    set, steps accepted against the robust total error with adaptive
    damping, an early stop when an accepted step improves the error by less
    than ``rel_tol`` (0 keeps the fixed iteration count).

    block_assign: optional node->shard assignment (default: the contiguous
    split, node i -> shard i // (N/S)); each shard takes at most N/S nodes.
    pallas_elimination: eliminate the interiors with ops/schur.spd_solve
    (kernel K2 on the card) instead of torch.linalg's Cholesky.

    Returns (poses, separator_count, lm_iterations). N must be divisible
    by the mesh size.
    """
    S = mesh.size
    N = poses.shape[0]
    if N % S != 0:
        raise ValueError(f"node capacity {N} must divide by mesh size {S}")
    if poses.device.type != mesh.device.type:
        raise ValueError(f"poses on {poses.device}, mesh on {mesh.device}")
    C = N // S
    dev = poses.device
    dt = poses.dtype
    idx = torch.arange(N, device=dev)
    shards = torch.arange(S, device=dev)

    if block_assign is None:
        block = idx // C
        int_rank = idx - block * C
        slot_map = idx.reshape(S, C)
    else:
        block = block_assign.to(device=dev, dtype=torch.int64)
        onehot = block[:, None] == shards[None, :]
        int_rank = (torch.cumsum(onehot.to(torch.int64), 0) - 1).gather(1, block[:, None])[:, 0]
        keep = int_rank < C
        slot_map = torch.full((S, C), N, dtype=torch.int64, device=dev)
        slot_map[block[keep], int_rank[keep]] = idx[keep]

    g_all = full_graph(prior_idx, prior_val, prior_sqrt_info, prior_mask,
                       edge_idx, edge_meas, edge_sqrt_info, edge_mask)
    ei = g_all.edge_idx[:, 0].long()
    ej = g_all.edge_idx[:, 1].long()
    pidx = g_all.prior_idx.long()

    # Separators: endpoints of cross-block edges.
    cross = edge_mask & (block[ei] != block[ej])
    is_sep = torch.zeros((N,), dtype=torch.bool, device=dev)
    is_sep[ei[cross]] = True
    is_sep[ej[cross]] = True
    is_sep = is_sep & node_mask
    sep_pos = torch.cumsum(is_sep.to(torch.int64), 0) - 1
    sep_count = is_sep.sum()
    sep_ok = is_sep & (sep_pos < sep_cap)
    sep_slot = torch.where(sep_ok, sep_pos, sep_cap)           # sep_cap = none

    # Factor routing.
    int_i = edge_mask & ~is_sep[ei]
    int_j = edge_mask & ~is_sep[ej]
    edge_owner = torch.where(int_i, block[ei], torch.where(int_j, block[ej], block[ei]))
    prior_owner = block[pidx]
    mine_e = (edge_owner[None, :] == shards[:, None]) & edge_mask      # (S, E)
    mine_p = (prior_owner[None, :] == shards[:, None]) & prior_mask    # (S, Pr)

    def int_slot(n):
        """(S, len(n)) interior slot of each node in each shard (C = none)."""
        ok = (block[n][None, :] == shards[:, None]) & (~is_sep[n] & node_mask[n] & (int_rank[n] < C))[None, :]
        return torch.where(ok, int_rank[n][None, :], C)

    li, lj, lp = int_slot(ei), int_slot(ej), int_slot(pidx)
    si_, sj_, sp = sep_slot[ei], sep_slot[ej], sep_slot[pidx]

    # Inactive interior slots carry identity rows (zero update).
    my_valid = slot_map < N                                        # (S, C)
    my_nodes = torch.clamp(slot_map, max=N - 1)
    int_ok = my_valid & node_mask[my_nodes] & ~is_sep[my_nodes]    # (S, C)
    int_valid = int_ok.repeat_interleave(3, dim=1)                 # (S, 3C)
    sep_valid = torch.zeros((sep_cap + 1,), dtype=torch.bool, device=dev)
    sep_valid[sep_slot[sep_ok]] = True
    sv = sep_valid[:sep_cap].repeat_interleave(3)

    C1, K1 = C + 1, sep_cap + 1
    s_col = shards[:, None]

    rows = dict(ii=S * C1 * C1, ss=S * K1 * K1, is_=S * C1 * K1, bi=S * C1, bs=S * K1)

    def routes(a_int, a_sep, b_int, b_sep, mine):
        """Where one factor set's J_a^T J_b products (and gradients) go,
        per target block tensor: the flat keys of each (S, F) product, in
        the order block_values lists them. Endpoints a, b are interior
        slots (C = none) or separator slots (sep_cap = none). A product of
        a factor a shard does not own (mine (S, F) false: an exact zero)
        is dropped."""
        a_sep, b_sep = a_sep[None, :].expand_as(a_int), b_sep[None, :].expand_as(b_int)

        def at(target, key):
            return torch.where(mine, key, rows[target]).reshape(-1)

        def blk(target, r, c, nrows, ncols):
            return at(target, (s_col * nrows + r) * ncols + c)

        return dict(
            ii=[blk("ii", a_int, a_int, C1, C1), blk("ii", b_int, b_int, C1, C1), blk("ii", a_int, b_int, C1, C1),
                blk("ii", b_int, a_int, C1, C1)],
            ss=[blk("ss", a_sep, a_sep, K1, K1), blk("ss", b_sep, b_sep, K1, K1), blk("ss", a_sep, b_sep, K1, K1),
                blk("ss", b_sep, a_sep, K1, K1)],
            is_=[blk("is_", a_int, b_sep, C1, K1), blk("is_", b_int, a_sep, C1, K1)],
            bi=[at("bi", s_col * C1 + a_int), at("bi", s_col * C1 + b_int)],
            bs=[at("bs", s_col * K1 + a_sep), at("bs", s_col * K1 + b_sep)],
        )

    def block_values(Ja, Jb, r, w):
        """The (S, F) products of one factor set (weights w (S, F)) per
        target, in the order of routes."""
        Hab = torch.einsum("fba,fbc->fac", Ja, Jb)[None] * w[..., None, None] ** 2
        Haa = torch.einsum("fba,fbc->fac", Ja, Ja)[None] * w[..., None, None] ** 2
        Hbb = torch.einsum("fba,fbc->fac", Jb, Jb)[None] * w[..., None, None] ** 2
        ga = torch.einsum("fba,fb->fa", Ja, r)[None] * w[..., None] ** 2
        gb = torch.einsum("fba,fb->fa", Jb, r)[None] * w[..., None] ** 2
        HabT = Hab.transpose(-1, -2)
        return dict(ii=[Haa, Hbb, Hab, HabT], ss=[Haa, Hbb, Hab, HabT], is_=[Hab, HabT], bi=[ga, gb], bs=[ga, gb])

    # Between factors, then priors (one endpoint: the other goes to the
    # padding slots). The keys are fixed for the solve: one plan per target.
    edge_keys = routes(li, si_, lj, sj_, mine_e)
    prior_keys = routes(lp, sp, torch.full_like(lp, C), torch.full_like(sp, sep_cap), mine_p)
    plans = {t: segment_plan(torch.cat(edge_keys[t] + prior_keys[t]), n) for t, n in rows.items()}

    def robust_error(p):
        er, _, _ = fg._between_residual_jac(p, g_all)
        pr, _ = fg._prior_residual_jac(p, g_all)
        er = er * edge_mask.to(dt)[:, None]
        pr = pr * prior_mask.to(dt)[:, None]
        return 0.5 * torch.sum(pr * pr) + robust_between_error(er, robust_delta)

    def gn_step(p, damping_c):
        er, Ji, Jj = fg._between_residual_jac(p, g_all)
        pr, pJ = fg._prior_residual_jac(p, g_all)
        er_m = er * edge_mask.to(dt)[:, None]
        pr_m = pr * prior_mask.to(dt)[:, None]
        err_lin = 0.5 * torch.sum(pr_m * pr_m) + robust_between_error(er_m, robust_delta)

        em = mine_e.to(dt)
        if robust_delta is not None:
            em = em * torch.sqrt(fg._huber_weight(er, robust_delta))[None, :]
        pm = mine_p.to(dt)

        edge_vals = block_values(Ji, Jj, er, em)
        prior_vals = block_values(pJ, torch.zeros_like(pJ), pr, pm)
        A_ii, A_ss, A_is, b_i, b_s = (
            segment_sum(torch.cat([v.reshape((-1,) + v.shape[2:]) for v in edge_vals[t] + prior_vals[t]]), plans[t])
            for t in ("ii", "ss", "is_", "bi", "bs")
        )

        Hii = _blocks(A_ii.view(S, C1, C1, 3, 3), C, C)
        His = _blocks(A_is.view(S, C1, K1, 3, 3), C, sep_cap)
        Hss = _blocks(A_ss.view(S, K1, K1, 3, 3), sep_cap, sep_cap)
        gi = b_i.view(S, C1, 3)[:, :C].reshape(S, 3 * C)
        gs = b_s.view(S, K1, 3)[:, :sep_cap].reshape(S, 3 * sep_cap)

        Hii = torch.where(int_valid[:, :, None] & int_valid[:, None, :], Hii, 0.0)
        Hii = Hii + torch.diag_embed(torch.where(int_valid, damping_c, 1.0))
        His = torch.where(int_valid[:, :, None], His, 0.0)
        gi = torch.where(int_valid, gi, 0.0)

        # Interior elimination of all shards at once.
        if pallas_elimination:
            sol = schur_ops.spd_solve(Hii, torch.cat([His, gi[:, :, None]], dim=2))
            W, u = sol[:, :, :-1], sol[:, :, -1]
        else:
            L, _ = torch.linalg.cholesky_ex(Hii)
            W = torch.cholesky_solve(His, L)
            u = torch.cholesky_solve(gi[:, :, None], L)[:, :, 0]
        HisT = His.transpose(1, 2)
        S_red = (Hss - HisT @ W).sum(0)
        g_red = (gs - (HisT @ u[:, :, None])[:, :, 0]).sum(0)

        S_red = torch.where(sv[:, None] & sv[None, :], S_red, 0.0)
        S_red = S_red + torch.diag(torch.where(sv, damping_c, 1.0))
        g_red = torch.where(sv, g_red, 0.0)
        Ls, _ = torch.linalg.cholesky_ex(S_red)
        d_sep = torch.cholesky_solve(g_red[:, None], Ls)[:, 0]                # (3 sep_cap,)

        d_int = u - (W @ d_sep[None, :, None])[:, :, 0]                       # (S, 3C)
        delta = torch.zeros((N, 3), dtype=dt, device=dev)
        d_int = torch.where(int_ok[:, :, None], d_int.view(S, C, 3), 0.0)
        delta[my_nodes[my_valid]] = d_int[my_valid]
        sep_delta = d_sep.view(sep_cap, 3)[torch.clamp(sep_slot, max=sep_cap - 1)]
        delta = delta + torch.where(sep_ok[:, None], sep_delta, 0.0)

        new = p - delta
        return torch.cat([new[:, :2], geom.wrap_angle(new[:, 2:3])], dim=1), err_lin

    damping_c = torch.tensor(damping, dtype=dt, device=dev)
    it = 0
    done = False
    while it < max_iterations and not done:
        cand, err_lin = gn_step(poses, damping_c)
        cand_err = robust_error(cand)
        accept = bool(cand_err < err_lin)
        if rel_tol > 0.0:
            improvement = (err_lin - cand_err) / torch.clamp(err_lin, min=1e-12)
            done = accept and bool(improvement < rel_tol)
        if accept:
            poses = cand
        damping_c = torch.clamp(damping_c * (0.5 if accept else 4.0), 1e-9, 1e6)
        it += 1
    return poses, int(sep_count), it
