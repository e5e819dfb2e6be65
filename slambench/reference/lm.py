"""Plain Levenberg-Marquardt over S pose graphs stacked on a lane axis.

The graph is a dict of (S, ...) tensors (prior_idx, prior_val,
prior_sqrt_info, num_priors, edge_idx, edge_meas, edge_sqrt_info,
num_edges). Between factors predict the pose of `to` in `from`'s frame;
priors pin a pose. Whitened residuals, Huber weights on the between
factors (IRLS), the dense damped normal matrix built block by block, and
one of three step solvers: "chol" (Cholesky, a lane at a time), "cg"
(block-Jacobi preconditioned CG, a fixed number of iterations on every
lane) — the session-batched solve — and the pass boundary's cold solve
("lanes": Cholesky on the lanes still running). Update rules: accept a
step that lowers a lane's error; damping x0.5 on accept, x4 on reject,
within [1e-9, 1e6]; stop a lane on a relative improvement below rel_tol
(terminate_on_reject: also on a reject after the first step's retry) or a
gradient below gradient_tol. `rnd` rounds the operands of every product.
"""

from __future__ import annotations

import torch

from slambench.reference import geom


def _residuals(poses, g, rnd):
    S, N = poses.shape[:2]
    lane = torch.arange(S, device=poses.device)[:, None]
    P, E = g["prior_idx"].shape[1], g["edge_idx"].shape[1]
    pm = torch.arange(P, device=poses.device) < g["num_priors"][:, None]
    em = torch.arange(E, device=poses.device) < g["num_edges"][:, None]
    pi = torch.where(pm, g["prior_idx"], 0).long()
    ei = torch.where(em[..., None], g["edge_idx"], 0).long()
    x = poses[lane, pi]
    pr = x - g["prior_val"]
    pr = torch.cat([pr[..., :2], geom.wrap(pr[..., 2:3])], dim=-1)
    xi, xj = poses[lane, ei[..., 0]], poses[lane, ei[..., 1]]
    c, s = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    dx, dy = xj[..., 0] - xi[..., 0], xj[..., 1] - xi[..., 1]
    er = torch.stack([c * dx + s * dy, -s * dx + c * dy, geom.wrap(xj[..., 2] - xi[..., 2])], dim=-1) - g["edge_meas"]
    er = torch.cat([er[..., :2], geom.wrap(er[..., 2:3])], dim=-1)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], -1), torch.stack([s, -c, -c * dx - s * dy], -1),
                      torch.stack([z, z, -o], -1)], -2)
    Jj = torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1), torch.stack([z, z, o], -1)], -2)
    Wp, We = rnd(g["prior_sqrt_info"]), rnd(g["edge_sqrt_info"])
    return (torch.einsum("spab,spb->spa", Wp, rnd(pr)), Wp, pi, pm,
            torch.einsum("seab,seb->sea", We, rnd(er)), torch.einsum("seab,sebc->seac", We, rnd(Ji)),
            torch.einsum("seab,sebc->seac", We, rnd(Jj)), ei, em)


def assemble(poses, g, node_mask, robust_delta, rnd):
    """(diag (S, N, 3, 3), off (S, E, 3, 3), rhs (S, N, 3), edge rows,
    edge mask, error (S,))."""
    S, N = poses.shape[:2]
    dev = poses.device
    pr, pJ, pi, pm, er, Ji, Jj, ei, em = _residuals(poses, g, rnd)
    pmf, emf = pm.float(), em.float()
    pr, pJ = pr * pmf[..., None], pJ * pmf[..., None, None]
    er = er * emf[..., None]
    nrm = torch.linalg.norm(er, dim=-1)
    err = 0.5 * (pr * pr).sum((1, 2))
    if robust_delta is None:
        err = err + 0.5 * (er * er).sum((1, 2))
        wgt = emf
    else:
        d = robust_delta
        err = err + torch.where(nrm <= d, 0.5 * nrm * nrm, d * nrm - 0.5 * d * d).sum(1)
        wgt = emf * torch.sqrt(torch.where(nrm <= d, 1.0, d / torch.clamp(nrm, min=1e-12)))
    er, Ji, Jj = er * wgt[..., None], Ji * wgt[..., None, None], Jj * wgt[..., None, None]
    lane = torch.arange(S, device=dev)
    diag = torch.zeros((S, N, 3, 3), device=dev)
    rhs = torch.zeros((S, N, 3), device=dev)
    li, le = lane[:, None].expand_as(pi), lane[:, None].expand_as(ei[..., 0])
    diag.index_put_((li, pi), rnd(pJ).transpose(-1, -2) @ rnd(pJ), accumulate=True)
    diag.index_put_((le, ei[..., 0]), rnd(Ji).transpose(-1, -2) @ rnd(Ji), accumulate=True)
    diag.index_put_((le, ei[..., 1]), rnd(Jj).transpose(-1, -2) @ rnd(Jj), accumulate=True)
    rhs.index_put_((li, pi), torch.einsum("spba,spb->spa", rnd(pJ), rnd(pr)), accumulate=True)
    rhs.index_put_((le, ei[..., 0]), torch.einsum("seba,seb->sea", rnd(Ji), rnd(er)), accumulate=True)
    rhs.index_put_((le, ei[..., 1]), torch.einsum("seba,seb->sea", rnd(Jj), rnd(er)), accumulate=True)
    off = rnd(Ji).transpose(-1, -2) @ rnd(Jj)
    eye = torch.eye(3, device=dev)
    diag = torch.where(node_mask[..., None, None], diag, eye)
    rhs = torch.where(node_mask[..., None], rhs, 0.0)
    return dict(diag=diag, off=off, rhs=rhs, ei=ei, em=em), err


def dense_H(eq, damping):
    S, N = eq["diag"].shape[:2]
    dev = eq["diag"].device
    eye = torch.eye(3, device=dev)
    blocks = torch.zeros((S, N, N, 3, 3), device=dev)
    n = torch.arange(N, device=dev)
    blocks[:, n, n] = eq["diag"] + damping[:, None, None, None] * eye
    lane = torch.arange(S, device=dev)[:, None].expand_as(eq["ei"][..., 0])
    off = eq["off"] * eq["em"][..., None, None].float()
    blocks.index_put_((lane, eq["ei"][..., 0], eq["ei"][..., 1]), off, accumulate=True)
    blocks.index_put_((lane, eq["ei"][..., 1], eq["ei"][..., 0]), off.transpose(-1, -2), accumulate=True)
    return blocks.permute(0, 1, 3, 2, 4).reshape(S, 3 * N, 3 * N)


def _chol(H, b, lanes):
    out = torch.zeros_like(b)
    for s in lanes:
        L, info = torch.linalg.cholesky_ex(H[s])
        out[s] = torch.cholesky_solve(b[s], L) if int(info) == 0 else float("nan")
    return out


def _cg(eq, H, damping, iters, rnd):
    S, N = eq["diag"].shape[:2]
    eye = torch.eye(3, device=H.device)
    Minv = rnd(geom.inv3(eq["diag"] + damping[:, None, None, None] * eye))
    b = eq["rhs"]
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("snab,snb->sna", Minv, rnd(r))
    p = z
    rz = (r * z).sum((1, 2))
    for _ in range(iters):
        Ap = (rnd(H) @ rnd(p).reshape(S, 3 * N, 1)).reshape(S, N, 3)
        den = (p * Ap).sum((1, 2))
        alpha = torch.where(den > 1e-20, rz / den, 0.0)[:, None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("snab,snb->sna", Minv, rnd(r))
        rz_new = (r * z).sum((1, 2))
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)[:, None, None]
        p = z + beta * p
        rz = rz_new
    return x


def _step(eq, damping, method, cg_iterations, lanes, rnd):
    S, N = eq["diag"].shape[:2]
    H = dense_H(eq, damping)
    if method == "cg":
        return _cg(eq, H, damping, cg_iterations, rnd)
    return _chol(rnd(H), rnd(eq["rhs"]).reshape(S, 3 * N, 1), lanes).reshape(S, N, 3)


def _gnorm(eq):
    return eq["rhs"].abs().amax(dim=(1, 2))


def solve(poses, g, node_mask, *, method: str, max_iterations: int, damping_init: float, robust_delta,
          gradient_tol: float = 0.0, terminate_on_reject: bool = False, rel_tol: float = 1e-6,
          cg_iterations: int = 12, rnd=geom.exact) -> torch.Tensor:
    """method "chol" / "cg": the session-batched solve (every lane steps
    max_iterations times, a done lane frozen); "lanes": the pass
    boundary's solve (only running lanes step; stops once none runs).
    Returns the (S, N, 3) poses."""
    S = poses.shape[0]
    dev = poses.device
    poses = rnd(poses)
    g = {k: rnd(v) for k, v in g.items()}
    eq, err = assemble(poses, g, node_mask, robust_delta, rnd)
    damping = torch.full((S,), damping_init, device=dev)
    accepted = torch.zeros((S,), dtype=torch.int32, device=dev)
    gnorm = _gnorm(eq)
    batched = method in ("chol", "cg")
    done = (gnorm <= gradient_tol) if (batched and gradient_tol > 0.0) else torch.zeros((S,), dtype=torch.bool, device=dev)
    for it in range(max_iterations):
        live = ~done if batched else ~done & (gnorm > gradient_tol)
        if not batched and not bool(live.any()):
            break
        lanes = range(S) if batched else torch.nonzero(live)[:, 0].tolist()
        delta = _step(eq, damping, "cg" if method == "cg" else "chol", cg_iterations, lanes, rnd)
        cand = poses - delta
        cand = torch.cat([cand[..., :2], geom.wrap(cand[..., 2:3])], dim=-1)
        eq_c, err_c = assemble(cand, g, node_mask, robust_delta, rnd)
        accept = err_c < err
        small = (err - err_c) / torch.clamp(err, min=1e-12) < rel_tol
        if terminate_on_reject:
            stop = small & (accept | (accepted > 0) | (it >= 1))
        else:
            stop = accept & small
        take = accept & live
        poses = torch.where(take[:, None, None], cand, poses)
        err = torch.where(take, err_c, err)
        eq = {k: torch.where(take.view((S,) + (1,) * (v.ndim - 1)), eq_c[k], v) if v.is_floating_point() else v
              for k, v in eq.items()}
        if batched and gradient_tol > 0.0:
            stop = stop | (take & (_gnorm(eq_c) <= gradient_tol))
        gnorm = torch.where(take, _gnorm(eq_c), gnorm)
        damping = torch.where(live, torch.clamp(damping * torch.where(accept, 0.5, 4.0), 1e-9, 1e6), damping)
        accepted = accepted + take.to(torch.int32)
        done = done | (live & stop)
    return poses
