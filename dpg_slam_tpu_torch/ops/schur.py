"""Batched SPD solve H X = B — the port of dpg_slam_tpu/ops/schur_pallas.py
(``spd_solve_pallas`` around the Pallas kernel ``_kernel``).

Two callers reach it: the Schur-elimination reoptimize, which eliminates
every shard's interior block in one call (parallel/schur.py,
``pallas_elimination=True``), and the LM solve's ``method="dense_pallas"``
(graph/factor_graph.py).

``spd_solve`` takes its path from the tensor's device: on a CPU tensor the
plain version below, on a CUDA tensor kernel K2 (ops/schur_cuda.py,
csrc/spd_solve_kernel.cu), or it raises. Nothing falls back.

``spd_solve_plain`` is the TPU kernel's algorithm in torch ops:
``_eliminate_blocked`` with the fused Cholesky-plus-inverse tile
``_chol_inv_tile`` at the panel ``_pick_panel`` chooses (128, 256 or 64,
at least two panels). Where no panel divides n, one panel of width n is
used (the JAX package's unblocked ``_eliminate`` is not carried). The
pivot is clamped as there, rsqrt(max(d, 1e-30)), so the kernel and the
plain version treat a matrix that is not SPD alike. Padded slots carry
identity rows (the callers build them so) and need no special case.
"""

from __future__ import annotations

import torch

__all__ = ["spd_solve", "spd_solve_plain"]

_PIVOT_FLOOR = 1e-30


def _pick_panel(n: int) -> int:
    """Panel width of the blocked elimination: the first of 128, 256, 64
    that divides n into at least two panels, else n (one panel)."""
    for p in (128, 256, 64):
        if n % p == 0 and n // p >= 2:
            return p
    return n


def _chol_inv_tile(D: torch.Tensor) -> torch.Tensor:
    """(..., p, p) SPD tiles -> the inverse of their Cholesky factors,
    chol(D)^-1, lower triangular: one p-step loop of masked rank-1
    Cholesky updates that also forward-substitutes the identity against
    each new column (schur_pallas._chol_inv_tile)."""
    p = D.shape[-1]
    A = D.clone()
    X = torch.eye(p, dtype=D.dtype, device=D.device).expand_as(D).clone()
    for j in range(p):
        inv = torch.rsqrt(torch.clamp(A[..., j, j], min=_PIVOT_FLOOR))[..., None]
        colj = A[..., j + 1:, j] * inv                    # rows > j of L[:, j]
        rowj = A[..., j, j + 1:] * inv                    # its transpose (symmetric trail)
        A[..., j + 1:, j + 1:] -= colj[..., :, None] * rowj[..., None, :]
        xj = X[..., j, :] * inv
        X[..., j, :] = xj
        X[..., j + 1:, :] -= colj[..., :, None] * xj[..., None, :]
    return torch.tril(X)


def spd_solve_plain(H: torch.Tensor, B: torch.Tensor, panel: int | None = None) -> torch.Tensor:
    """X with H X = B for (n, n) or (S, n, n) SPD H and (n, m) or (S, n, m)
    B, float32, by the panel-blocked elimination
    (schur_pallas._eliminate_blocked) at `panel` (default _pick_panel(n)).
    A batch is solved one system at a time, as the kernel's grid takes
    one system a program: a batched matmul rounds otherwise than a
    one-system one, and a system's bits must not depend on its batch."""
    n = H.shape[-1]
    p = panel or _pick_panel(n)
    if n % p != 0:
        raise ValueError(f"panel {p} does not divide n={n}")
    if H.ndim == 3:
        return torch.stack([_blocked_solve(h, b, p) for h, b in zip(H, B)])
    return _blocked_solve(H, B, p)


def _blocked_solve(H: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """spd_solve_plain on one (n, n) system at panel p."""
    nb = H.shape[-1] // p
    linvs, lbelows = [], []
    trail = H
    for k in range(nb):
        Linv = _chol_inv_tile(trail[..., :p, :p])
        linvs.append(Linv)
        if k + 1 < nb:
            Lbelow = trail[..., p:, :p] @ Linv.transpose(-1, -2)
            lbelows.append(Lbelow)
            trail = trail[..., p:, p:] - Lbelow @ Lbelow.transpose(-1, -2)
        else:
            lbelows.append(None)

    ys = []
    rest = B
    for k in range(nb):
        Yk = linvs[k] @ rest[..., :p, :]
        ys.append(Yk)
        if lbelows[k] is not None:
            rest = rest[..., p:, :] - lbelows[k] @ Yk

    xs = [None] * nb
    for k in reversed(range(nb)):
        acc = ys[k]
        if lbelows[k] is not None:
            acc = acc - lbelows[k].transpose(-1, -2) @ torch.cat(xs[k + 1:], dim=-2)
        xs[k] = linvs[k].transpose(-1, -2) @ acc
    return torch.cat(xs, dim=-2)


def spd_solve(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve H X = B for a batch of SPD systems: H (S, n, n) and B (S, n, m)
    float32, or the same without S. The plain version on a CPU tensor,
    kernel K2 on a CUDA tensor."""
    if H.ndim not in (2, 3) or B.ndim != H.ndim:
        raise ValueError(f"spd_solve takes (S, n, n) and (S, n, m), got {tuple(H.shape)} and {tuple(B.shape)}")
    n = H.shape[-1]
    if H.shape[-2] != n or B.shape[-2] != n or H.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"spd_solve: shapes {tuple(H.shape)} and {tuple(B.shape)} do not match")
    if H.device.type == "cpu":
        return spd_solve_plain(H.to(torch.float32), B.to(torch.float32))
    if H.device.type != "cuda":
        raise ValueError(f"spd_solve runs on a CPU or CUDA tensor, got {H.device}")
    from dpg_slam_tpu_torch.ops import schur_cuda

    if H.ndim == 2:
        return schur_cuda.spd_solve_cuda(H[None].contiguous(), B[None].contiguous())[0]
    return schur_cuda.spd_solve_cuda(H.contiguous(), B.contiguous())
