"""Port parity: dpg_slam_tpu_torch.graph.factor_graph against the JAX
package's solver on the same seeded graphs.

Tolerances: normal-equation blocks and rhs rtol 1e-5 (float32 sums of a
few terms per node in another order; atol 1e-3 only for entries that
cancel to near zero, against entries of 1e2..1e4); slot packing exact; solved poses
atol 1e-4 (a 20-node LM solve in float32, where the two Cholesky /
CG implementations round differently); the GTSAM 5-pose fixture at
test_graph.py's own atol 1e-3; method="dense_pallas" against the JAX
package at 5e-4, tests/test_graph.py's bound for it against "dense".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu.graph import factor_graph as jfg
from dpg_slam_tpu_torch.graph import factor_graph as tfg

from test_graph import EXPECTED


def _random_graph(seed, n_nodes=20, n_edges=40, cap_nodes=24, cap_edges=64):
    """Chain + random closures with noisy measurements, as numpy arrays."""
    rng = np.random.default_rng(seed)
    truth = np.cumsum(rng.normal([0.8, 0.1, 0.05], 0.2, (n_nodes, 3)), axis=0)
    pairs = [(i, i + 1) for i in range(n_nodes - 1)]
    while len(pairs) < n_edges:
        i, j = sorted(rng.choice(n_nodes, 2, replace=False))
        pairs.append((int(i), int(j)))
    pairs = np.array(pairs, np.int32)

    def between(a, b):
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        d = b[:, :2] - a[:, :2]
        th = np.angle(np.exp(1j * (b[:, 2] - a[:, 2])))
        return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], th], -1)

    meas = between(truth[pairs[:, 0]], truth[pairs[:, 1]]) + rng.normal(0, 0.02, (n_edges, 3))
    meas[-3:] += np.array([1.5, -1.0, 0.8])  # outliers: Huber territory
    A = rng.normal(size=(n_edges, 3, 3)) * 0.05
    cov = A @ A.transpose(0, 2, 1) + np.diag([0.01, 0.01, 0.005])
    init = np.zeros((cap_nodes, 3), np.float32)
    init[:n_nodes] = truth + rng.normal(0, 0.15, truth.shape)
    return dict(
        pairs=pairs, meas=meas.astype(np.float32), cov=cov.astype(np.float32),
        init=init, n_nodes=n_nodes, cap_edges=cap_edges,
        valid=rng.uniform(size=n_edges) > 0.1,
    )


def _build(spec, lib, mk, cap_priors=4):
    """The same graph through either package: `mk` makes its arrays."""
    if lib is tfg:
        g = lib.empty_graph(cap_priors, spec["cap_edges"], "cpu")
    else:
        g = lib.empty_graph(cap_priors, spec["cap_edges"])
    si = lib.sqrt_info_from_sigmas(mk(np.array([0.1, 0.1, 0.05], np.float32)))
    if lib is tfg:
        g = lib.add_prior(g, 0, mk(np.zeros(3, np.float32)), si)
    else:
        g = lib.add_prior(g, jnp.int32(0), mk(np.zeros(3, np.float32)), si)
    return lib.add_between_batch(
        g, mk(spec["pairs"][:, 0]), mk(spec["pairs"][:, 1]), mk(spec["meas"]),
        lib.sqrt_info_from_covariance(mk(spec["cov"])), mk(spec["valid"]),
    )


def _both(spec):
    tg = _build(spec, tfg, torch.from_numpy)
    jg = _build(spec, jfg, jnp.asarray)
    mask = np.arange(spec["init"].shape[0]) < spec["n_nodes"]
    return tg, jg, mask


def test_add_between_batch_slot_packing():
    spec = _random_graph(0, cap_edges=32)  # 40 rows, ~36 valid: overflow drops
    tg, jg, _ = _both(spec)
    assert int(tg.num_edges) == int(jg.num_edges) == int(spec["valid"].sum())
    for f in ("edge_idx", "edge_meas", "edge_sqrt_info", "prior_idx", "prior_val", "prior_sqrt_info"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)


def test_add_between_invalid_slot_not_consumed():
    g = tfg.empty_graph(2, 4, "cpu")
    si = tfg.sqrt_info_from_sigmas(torch.tensor([0.2, 0.2, 0.1]))
    g = tfg.add_between(g, 0, 1, torch.ones(3), si, valid=False)
    assert int(g.num_edges) == 0
    g = tfg.add_between(g, 0, 1, torch.ones(3), si, valid=True)
    assert int(g.num_edges) == 1 and g.edge_idx[0].tolist() == [0, 1]


def test_sqrt_info_from_covariance_matches_jax():
    cov = _random_graph(1)["cov"]
    np.testing.assert_allclose(
        tfg.sqrt_info_from_covariance(torch.from_numpy(cov)).numpy(),
        np.asarray(jfg.sqrt_info_from_covariance(jnp.asarray(cov))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("robust_delta", [None, 2.0])
def test_assemble_matches_jax(robust_delta):
    spec = _random_graph(2)
    tg, jg, mask = _both(spec)
    teq, terr = tfg._assemble(torch.from_numpy(spec["init"]), tg, torch.from_numpy(mask), robust_delta)
    jeq, jerr = jfg._assemble(jnp.asarray(spec["init"]), jg, jnp.asarray(mask), robust_delta)
    for name in ("diag", "off", "rhs"):
        np.testing.assert_allclose(
            getattr(teq, name).numpy(), np.asarray(getattr(jeq, name)), rtol=1e-5, atol=1e-3, err_msg=name
        )
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
    np.testing.assert_allclose(
        float(tfg.total_error(torch.from_numpy(spec["init"]), tg, robust_delta)), float(jerr), rtol=1e-5
    )
    np.testing.assert_allclose(
        tfg.residuals(torch.from_numpy(spec["init"]), tg).numpy(),
        np.asarray(jfg.residuals(jnp.asarray(spec["init"]), jg)), rtol=1e-5, atol=1e-4,
    )
    # The dense system from the block form.
    damping = 1e-3
    tH = tfg._dense_H(teq, tg, torch.tensor(damping))
    jH = jfg._dense_H(jeq, jg, jnp.float32(damping))
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("method", ["dense", "dense_cg", "cg"])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_matches_jax(method, warm):
    spec = _random_graph(3)
    tg, jg, mask = _both(spec)
    kw = dict(
        max_iterations=5 if warm else 20, method=method, cg_iterations=64,
        robust_delta=2.0, gradient_tol=1e-4 if warm else 0.0,
        terminate_on_reject=warm, rel_tol=1e-4 if warm else 1e-5,
    )
    tp, ts = tfg.solve(torch.from_numpy(spec["init"]), tg, torch.from_numpy(mask), **kw)
    jp, js = jfg.solve(jnp.asarray(spec["init"]), jg, jnp.asarray(mask), **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    assert ts.iterations == int(js.iterations)
    np.testing.assert_allclose(float(ts.final_error), float(js.final_error), rtol=1e-4)
    assert float(ts.final_error) < float(ts.initial_error)


def _chain64():
    """tests/test_graph.py's 64-node chain with three closures (3N = 192,
    so the blocked elimination runs at panel 64), as numpy arrays."""
    rng = np.random.default_rng(11)
    N = 64
    gt = np.cumsum(rng.normal(0.5, 0.1, size=(N, 3)) * [1, 0.2, 0.05], axis=0)
    pairs = [(i, i + 1) for i in range(N - 1)] + [(0, 20), (10, 40), (25, 63)]
    meas = np.stack([gt[j] - gt[i] for i, j in pairs]).astype(np.float32)
    init = (gt + rng.normal(0, 0.05, size=(N, 3))).astype(np.float32)
    return np.array(pairs, np.int32), meas, init


def _chain64_graph(lib, mk):
    pairs, meas, init = _chain64()
    if lib is tfg:
        g = lib.empty_graph(4, 256, "cpu")
        g = lib.add_prior(g, 0, mk(np.zeros(3, np.float32)), lib.sqrt_info_from_sigmas(mk(np.full(3, 0.01, np.float32))))
    else:
        g = lib.empty_graph(4, 256)
        g = lib.add_prior(g, jnp.int32(0), mk(np.zeros(3, np.float32)),
                          lib.sqrt_info_from_sigmas(mk(np.full(3, 0.01, np.float32))))
    si = lib.sqrt_info_from_sigmas(mk(np.array([0.1, 0.1, 0.05], np.float32)))
    n = len(pairs)
    g = lib.add_between_batch(
        g, mk(pairs[:, 0]), mk(pairs[:, 1]), mk(meas),
        si[None].expand(n, 3, 3) if lib is tfg else jnp.broadcast_to(si, (n, 3, 3)), mk(np.ones(n, bool)),
    )
    return g, mk(init), mk(np.ones(64, bool))


def test_dense_pallas_matches_jax_at_blocked_size():
    """solve(method="dense_pallas") against the JAX package's (its Pallas
    body interpreted on the CPU) and against "dense": atol 5e-4, the bound
    tests/test_graph.py holds dense_pallas to against dense."""
    tg, tinit, tmask = _chain64_graph(tfg, torch.from_numpy)
    jg, jinit, jmask = _chain64_graph(jfg, jnp.asarray)
    tp, ts = tfg.solve(tinit, tg, tmask, method="dense_pallas", max_iterations=15)
    jp, js = jfg.solve(jinit, jg, jmask, method="dense_pallas", max_iterations=15)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-4)
    assert ts.iterations == int(js.iterations)
    dense, _ = tfg.solve(tinit, tg, tmask, method="dense", max_iterations=15)
    np.testing.assert_allclose(tp.numpy(), dense.numpy(), atol=5e-4)


def test_dense_pallas_gtsam_matches_jax():
    from test_graph import build_gtsam_fixture

    jg, jinit, jmask = build_gtsam_fixture()
    tg, tinit, tmask = _gtsam_fixture()
    tp, _ = tfg.solve(tinit, tg, tmask, method="dense_pallas", max_iterations=30)
    jp, _ = jfg.solve(jinit, jg, jmask, method="dense_pallas", max_iterations=30)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-4)


def _gtsam_fixture():
    """test_graph.build_gtsam_fixture in the port."""
    g = tfg.empty_graph(4, 16, "cpu")
    g = tfg.add_prior(g, 0, torch.zeros(3), tfg.sqrt_info_from_sigmas(torch.tensor([0.3, 0.3, 0.1])))
    model = tfg.sqrt_info_from_sigmas(torch.tensor([0.2, 0.2, 0.1]))
    hp = np.pi / 2
    for i, j, m in [(0, 1, [2, 0, 0]), (1, 2, [2, 0, hp]), (2, 3, [2, 0, hp]), (3, 4, [2, 0, hp]), (4, 1, [2, 0, hp])]:
        g = tfg.add_between(g, i, j, torch.tensor(m, dtype=torch.float32), model)
    init = torch.zeros((8, 3))
    init[:5] = torch.tensor(
        [[0.5, 0.0, 0.2], [2.3, 0.1, -0.2], [4.1, 0.1, hp], [4.0, 2.0, np.pi], [2.1, 2.1, -hp]]
    )
    return g, init, torch.arange(8) < 5


@pytest.mark.parametrize("method", ["dense", "cg", "dense_cg", "dense_pallas"])
def test_gtsam_fixture_optimum(method):
    g, init, mask = _gtsam_fixture()
    poses, stats = tfg.solve(init, g, mask, method=method, max_iterations=30)
    got = poses[:5].numpy()
    np.testing.assert_allclose(got[:, :2], EXPECTED[:, :2], atol=1e-3)
    ang_err = np.abs(np.angle(np.exp(1j * (got[:, 2] - EXPECTED[:, 2]))))
    np.testing.assert_allclose(ang_err, 0.0, atol=1e-3)
    assert float(stats.final_error) < 1e-6 < float(stats.initial_error)
    # Masked slots pass through untouched.
    np.testing.assert_array_equal(poses[5:].numpy(), init[5:].numpy())
