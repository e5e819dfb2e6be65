"""Serial CPU re-execution of the reference's per-keyframe work.

The port's copy of dpg_slam_tpu/baselines/serial_cpu.py (numpy and
ctypes over native/build/libdpgslam_host.so): the C++ baseline harness
the port's bench calls.

Mirrors the reference execution model for an apples-to-apples frames/s
baseline (BASELINE.md: "The C++ baseline frames/s must be measured by
building/running the reference (or a faithful re-execution harness)"):

  * one successive-scan ICP + one ICP per loop-closure candidate, run
    SERIALLY pair by pair (dpg_slam.cc:262-304);
  * point-to-point ICP with nearest-neighbor correspondences, reciprocal
    filtering and a max-correspondence gate, iterated to convergence with
    an epsilon stop (PCL configuration at dpg_slam.cc:408-412);
  * a full-graph Gauss-Newton solve after the keyframe's factors are
    added (the reference re-adds ALL factors to iSAM2 each update —
    SURVEY.md §3.6.2 — so a full batch solve per keyframe matches its
    effective cost model).

Pure numpy, single thread, early exits allowed (a serial CPU benefits
from them; fixed-shape TPU code does not).
"""

from __future__ import annotations

import ctypes

import numpy as np

from dpg_slam_tpu_torch.io.logs import native_lib

__all__ = [
    "icp_serial",
    "solve_serial",
    "keyframe_step_serial",
    "native_baseline_bench",
    "native_baseline_reoptimize",
]


_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_D = ctypes.POINTER(ctypes.c_double)
_INT, _DBL = ctypes.c_int, ctypes.c_double


def native_baseline_reoptimize(
    clouds, poses, odom_poses, pass_ids, prior_sqrt_info, odo_sqrt_info, *,
    radius_within, radius_cross, min_gap, closures_k, icp_params,
    gn_iters=20, return_poses=False,
):
    """The reference's reoptimize (dpg_slam.cc:35-120) run serially in
    native C++ (native/serial_baseline.cc): every successive-pair ICP,
    every in-radius loop-closure ICP (K nearest per node), one full GN.
    Returns (seconds, n_icp_pairs, final_poses|None) or None when the
    native library is unavailable."""
    lib = native_lib()
    if lib is None or not hasattr(lib, "baseline_reoptimize"):
        return None
    n = len(clouds)
    max_p = max(len(c) for c in clouds)
    cl = np.zeros((n, max_p, 2), np.float32)
    sizes = np.zeros((n,), np.int32)
    for i, c in enumerate(clouds):
        cl[i, : len(c)] = c
        sizes[i] = len(c)
    poses_in = np.ascontiguousarray(poses, np.float64)
    odom_in = np.ascontiguousarray(odom_poses, np.float64)
    pids = np.ascontiguousarray(pass_ids, np.int32)
    prior_w = np.ascontiguousarray(prior_sqrt_info, np.float64).reshape(9)
    odo_w = np.ascontiguousarray(odo_sqrt_info, np.float64).reshape(9)
    out = np.zeros((n * 3,), np.float64)
    pairs = np.zeros((1,), np.int32)

    f = lib.baseline_reoptimize
    f.restype = ctypes.c_double
    f.argtypes = [_F, _I, _INT, _INT, _D, _D, _I, _D, _D, _DBL, _DBL, _INT, _INT, _INT, _DBL, _DBL, _INT, _D, _I]
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    seconds = f(
        p(cl, ctypes.c_float), p(sizes, ctypes.c_int32),
        ctypes.c_int(n), ctypes.c_int(max_p),
        p(poses_in, ctypes.c_double), p(odom_in, ctypes.c_double),
        p(pids, ctypes.c_int32),
        p(prior_w, ctypes.c_double), p(odo_w, ctypes.c_double),
        ctypes.c_double(radius_within), ctypes.c_double(radius_cross),
        ctypes.c_int(min_gap), ctypes.c_int(closures_k),
        ctypes.c_int(icp_params.get("max_iters", 60)),
        ctypes.c_double(icp_params.get("gate", 0.6)),
        ctypes.c_double(icp_params.get("epsilon", 5e-9)),
        ctypes.c_int(gn_iters),
        p(out, ctypes.c_double), p(pairs, ctypes.c_int32),
    )
    res_poses = out.reshape(-1, 3) if return_poses else None
    return seconds, int(pairs[0]), res_poses


def native_baseline_bench(
    clouds, poses, edges, prior_sqrt_info, new_clouds, odom_deltas,
    odo_sqrt_info, *, closures_k, icp_params, return_poses=False,
):
    """Run the benchmark keyframe loop in the native C++ baseline
    (native/serial_baseline.cc) — same semantics as this module, compiled
    single-thread C++, on real continuation keyframes. Returns
    (keyframes/s, final_poses|None), or None when the native library is
    unavailable.

    clouds: list of (P_i, 2) primed node clouds; poses: (n0, 3);
    edges: [(i, j, meas(3,), sqrt_info(3,3))] odometry chain;
    new_clouds: list of (P_k, 2) never-seen keyframe clouds;
    odom_deltas: (n_steps, 3) robot-frame odometry displacement per step.
    """
    lib = native_lib()
    if lib is None or not hasattr(lib, "baseline_bench"):
        return None
    n0 = len(clouds)
    n_steps = len(new_clouds)
    max_p = max(max(len(c) for c in clouds), max(len(c) for c in new_clouds))

    def pack(cloud_list):
        n = len(cloud_list)
        arr = np.zeros((n, max_p, 2), np.float32)
        sz = np.zeros((n,), np.int32)
        for i, c in enumerate(cloud_list):
            arr[i, : len(c)] = c
            sz[i] = len(c)
        return arr, sz

    cl, sizes = pack(clouds)
    ncl, nsizes = pack(new_clouds)
    poses0 = np.ascontiguousarray(poses, np.float64)
    e_idx = np.array([[i, j] for i, j, _, _ in edges], np.int32).reshape(-1, 2)
    e_meas = np.array([m for _, _, m, _ in edges], np.float64).reshape(-1, 3)
    e_w = np.array([w for _, _, _, w in edges], np.float64).reshape(-1, 9)
    prior_w = np.ascontiguousarray(prior_sqrt_info, np.float64).reshape(9)
    odo_w = np.ascontiguousarray(odo_sqrt_info, np.float64).reshape(9)
    deltas = np.ascontiguousarray(odom_deltas, np.float64).reshape(-1, 3)
    out = np.zeros(((n0 + n_steps) * 3,), np.float64)

    f = lib.baseline_bench
    f.restype = ctypes.c_double
    f.argtypes = [_F, _I, _INT, _INT, _D, _I, _D, _D, _INT, _D, _F, _I, _D, _D, _INT, _INT, _DBL, _DBL, _INT, _D]
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    seconds = f(
        p(cl, ctypes.c_float), p(sizes, ctypes.c_int32),
        ctypes.c_int(n0), ctypes.c_int(max_p),
        p(poses0, ctypes.c_double),
        p(e_idx, ctypes.c_int32), p(e_meas, ctypes.c_double),
        p(e_w, ctypes.c_double), ctypes.c_int(len(edges)),
        p(prior_w, ctypes.c_double),
        p(ncl, ctypes.c_float), p(nsizes, ctypes.c_int32),
        p(deltas, ctypes.c_double), p(odo_w, ctypes.c_double),
        ctypes.c_int(closures_k),
        ctypes.c_int(icp_params.get("max_iters", 60)),
        ctypes.c_double(icp_params.get("gate", 0.6)),
        ctypes.c_double(icp_params.get("epsilon", 5e-9)),
        ctypes.c_int(n_steps),
        p(out, ctypes.c_double),
    )
    fps = n_steps / seconds if seconds > 0 else None
    return (fps, out.reshape(-1, 3)) if return_poses else (fps, None)


def _wrap(a):
    return np.angle(np.exp(1j * a))


def icp_serial(src, tgt, seed, *, max_iters=60, gate=0.6, epsilon=5e-9):
    """Point-to-point 2D ICP, one pair, serial iterations with early stop.

    Returns (transform (3,), converged, n_matches).
    """
    t = np.asarray(seed, np.float64).copy()
    n_matches = 0
    for _ in range(max_iters):
        c, s = np.cos(t[2]), np.sin(t[2])
        R = np.array([[c, -s], [s, c]])
        moved = src @ R.T + t[:2]
        # NN via full distance matrix (the PCL kd-tree analog; for ~200
        # points the dense matrix is the fair single-thread comparison).
        d2 = ((moved[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        nn = d2.argmin(1)
        nn_d2 = d2[np.arange(len(src)), nn]
        w = nn_d2 <= gate * gate
        rev = d2.argmin(0)
        w &= rev[nn] == np.arange(len(src))
        n_matches = int(w.sum())
        if n_matches < 3:
            return t, False, n_matches
        p = moved[w]
        q = tgt[nn[w]]
        # Closed-form 2D rigid alignment (Horn) of current correspondences.
        mp, mq = p.mean(0), q.mean(0)
        pc, qc = p - mp, q - mq
        num = (pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0]).sum()
        den = (pc * qc).sum()
        dth = np.arctan2(num, den)
        cd, sd = np.cos(dth), np.sin(dth)
        Rd = np.array([[cd, -sd], [sd, cd]])
        dt = mq - Rd @ mp
        # Compose increment with current transform.
        new_t = np.empty(3)
        new_t[:2] = Rd @ t[:2] + dt
        new_t[2] = _wrap(t[2] + dth)
        step = new_t - t
        step[2] = _wrap(step[2])
        t = new_t
        if (step**2).sum() < epsilon:
            break
    return t, True, n_matches


def solve_serial(poses, priors, edges, *, iters=10):
    """Dense Gauss-Newton over the whole graph (numpy Cholesky).

    priors: list of (idx, value(3,), sqrt_info(3,3))
    edges: list of (i, j, meas(3,), sqrt_info(3,3))
    """
    poses = np.asarray(poses, np.float64).copy()
    N = len(poses)
    for _ in range(iters):
        H = np.zeros((3 * N, 3 * N))
        b = np.zeros(3 * N)
        for idx, val, W in priors:
            r = poses[idx] - val
            r[2] = _wrap(r[2])
            J = W
            H[3 * idx:3 * idx + 3, 3 * idx:3 * idx + 3] += J.T @ J
            b[3 * idx:3 * idx + 3] += J.T @ (W @ r)
        for i, j, meas, W in edges:
            xi, xj = poses[i], poses[j]
            c, s = np.cos(xi[2]), np.sin(xi[2])
            dx, dy = xj[0] - xi[0], xj[1] - xi[1]
            pred = np.array(
                [c * dx + s * dy, -s * dx + c * dy, _wrap(xj[2] - xi[2])]
            )
            r = pred - meas
            r[2] = _wrap(r[2])
            Ji = np.array(
                [[-c, -s, -s * dx + c * dy], [s, -c, -c * dx - s * dy], [0, 0, -1.0]]
            )
            Jj = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
            Wr = W @ r
            WJi, WJj = W @ Ji, W @ Jj
            si, sj = slice(3 * i, 3 * i + 3), slice(3 * j, 3 * j + 3)
            H[si, si] += WJi.T @ WJi
            H[sj, sj] += WJj.T @ WJj
            H[si, sj] += WJi.T @ WJj
            H[sj, si] += WJj.T @ WJi
            b[si] += WJi.T @ Wr
            b[sj] += WJj.T @ Wr
        H += 1e-6 * np.eye(3 * N)
        delta = np.linalg.solve(H, b)
        poses = poses - delta.reshape(N, 3)
        poses[:, 2] = _wrap(poses[:, 2])
        if (delta**2).sum() < 1e-12:
            break
    return poses


def keyframe_step_serial(
    clouds, poses, new_cloud, seed_pose, priors, edges, *,
    closure_candidates, icp_params=None,
):
    """One reference-equivalent keyframe: serial successive ICP, serial
    loop-closure ICPs, factor appends, full-graph GN solve.

    clouds: list of (P, 2) arrays for existing nodes.
    poses: (N, 3) current estimates.
    Returns (updated poses incl. the new node, edges).
    """
    icp_params = icp_params or {}
    N = len(clouds)
    fixed_W = np.linalg.inv(np.linalg.cholesky(np.diag([0.5, 0.5, 0.3]))).T

    new_poses = np.vstack([poses, seed_pose[None]])
    # Successive ICP (dpg_slam.cc:262-267).
    if N > 0:
        prev = N - 1
        c, s = np.cos(poses[prev, 2]), np.sin(poses[prev, 2])
        Rp = np.array([[c, s], [-s, c]])
        rel_seed = np.array(
            [*(Rp @ (seed_pose[:2] - poses[prev, :2])), _wrap(seed_pose[2] - poses[prev, 2])]
        )
        t, _, _ = icp_serial(new_cloud, clouds[prev], rel_seed, **icp_params)
        edges.append((prev, N, t, fixed_W))
        # Loop closures, serially (dpg_slam.cc:273-304).
        for j in closure_candidates:
            cj, sj_ = np.cos(poses[j, 2]), np.sin(poses[j, 2])
            Rj = np.array([[cj, sj_], [-sj_, cj]])
            seed_j = np.array(
                [*(Rj @ (seed_pose[:2] - poses[j, :2])), _wrap(seed_pose[2] - poses[j, 2])]
            )
            tj, ok, _ = icp_serial(new_cloud, clouds[j], seed_j, **icp_params)
            if ok:
                edges.append((j, N, tj, fixed_W))

    new_poses = solve_serial(new_poses, priors, edges, iters=5)
    return new_poses, edges
