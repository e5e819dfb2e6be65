"""Port parity: the batched SPD solve (ops/schur.py), the spatial
partition and the Schur-elimination solve (parallel/schur.py) against the
JAX package on the same seeded inputs, the JAX side on its virtual 8-device
CPU mesh with the Pallas kernel body in interpret mode.

Tolerances:
- plain SPD solve vs spd_solve_pallas(interpret=True): atol 1e-5 x max|X|
  (the same blocked algorithm in float32, sums in another order); both
  within 2e-4 of cho_factor/cho_solve, tests/test_schur.py's bound;
- spatial_blocks: exact (the same numpy);
- schur_solve at 8 shards: equal separator counts (integer bookkeeping),
  poses atol 1e-4 (float32 LM of up to 30 iterations; the elimination
  sums in another order).
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from dpg_slam_tpu import geom as jgeom
from dpg_slam_tpu.graph import factor_graph as jfg
from dpg_slam_tpu.ops.schur_pallas import spd_solve_pallas
from dpg_slam_tpu.parallel import make_mesh as jmake_mesh
from dpg_slam_tpu.parallel.partition import spatial_blocks as jspatial_blocks
from dpg_slam_tpu.parallel.schur import schur_solve as jschur_solve
from dpg_slam_tpu_torch.ops import schur, schur_cuda
from dpg_slam_tpu_torch.parallel import make_mesh, schur_solve
from dpg_slam_tpu_torch.parallel.partition import spatial_blocks

from test_schur import chain_graph_with_closures, outlier_graph


def _spd(rng, n, pad, S=None):
    """A damped SPD matrix with identity rows in its last `pad` slots."""
    shape = (n, n) if S is None else (S, n, n)
    A = rng.normal(size=shape)
    H = A @ np.swapaxes(A, -1, -2) / n + 3.0 * np.eye(n)
    if pad:
        H[..., -pad:, :] = 0.0
        H[..., :, -pad:] = 0.0
        H[..., np.arange(n - pad, n), np.arange(n - pad, n)] = 1.0
    return H.astype(np.float32)


@pytest.mark.parametrize("case", ["n48_padded", "n256_panel64", "n256_panel128", "n72_no_panel", "batch3"])
def test_spd_solve_plain_matches_jax(case):
    rng = np.random.default_rng(3)
    panel = None
    if case == "n48_padded":
        H, B = _spd(rng, 48, 6), rng.normal(size=(48, 17))
    elif case.startswith("n256"):
        panel = int(case[len("n256_panel"):])
        H, B = _spd(rng, 256, 9), rng.normal(size=(256, 33))
    elif case == "n72_no_panel":
        H, B = _spd(rng, 72, 0), rng.normal(size=(72, 5))
    else:
        H, B = _spd(rng, 128, 4, S=3), rng.normal(size=(3, 128, 7))
    B = B.astype(np.float32)
    got = schur.spd_solve_plain(torch.from_numpy(H), torch.from_numpy(B), panel=panel).numpy()
    Hs, Bs = (H, B) if H.ndim == 3 else (H[None], B[None])
    want = np.stack([np.asarray(spd_solve_pallas(jnp.asarray(h), jnp.asarray(b), interpret=True, panel=panel))
                     for h, b in zip(Hs, Bs)]).reshape(got.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    exact = np.stack([np.asarray(jsl.cho_solve(jsl.cho_factor(jnp.asarray(h)), jnp.asarray(b)))
                      for h, b in zip(Hs, Bs)]).reshape(got.shape)
    np.testing.assert_allclose(got, exact, atol=2e-4)
    np.testing.assert_allclose(want, exact, atol=2e-4)
    # The dispatcher takes the plain version on a CPU tensor.
    np.testing.assert_array_equal(
        schur.spd_solve(torch.from_numpy(H), torch.from_numpy(B)).numpy(),
        schur.spd_solve_plain(torch.from_numpy(H), torch.from_numpy(B)).numpy(),
    )


def test_spd_solve_rejects_other_devices_and_shapes():
    H = torch.eye(6, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        schur.spd_solve(H, torch.zeros((6, 2), device="meta"))
    with pytest.raises(ValueError, match="do not match"):
        schur.spd_solve(torch.eye(6), torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="panel"):
        schur.spd_solve_plain(torch.eye(6), torch.zeros((6, 2)), panel=4)


@pytest.mark.parametrize(
    "S,n,m,plan",
    [
        # The inputs of K2's three paths.
        (1, 192, 1, ("single", 64, 1, True)),     # dense_pallas keyframe solve (bucket 64)
        (1, 768, 1, ("multi", 64, 1, True)),      # dense_pallas reoptimize (bucket 256)
        (4, 192, 385, ("single", 64, 193, False)),  # Schur interiors, 4 shards
        # Edges of the two thresholds (n 224 | 225, m 31 | 32).
        (1, 224, 1, ("single", 64, 1, True)),
        (1, 225, 1, ("multi", 64, 1, True)),
        (1, 256, 1, ("multi", 64, 1, True)),
        (1, 224, 31, ("single", 64, 31, True)),
        (1, 225, 32, ("multi", 64, 32, False)),
        (1, 256, 385, ("multi", 64, 193, False)),
        (2, 256, 31, ("multi", 64, 31, True)),
        (1, 512, 3, ("multi", 64, 3, True)),
    ],
)
def test_k2_launch_plan(S, n, m, plan):
    """The CUDA wrapper's dispatch: the many-CTA factorization from n = 225,
    warp-per-column substitution below m = 32, panel and column chunk as
    before."""
    got = schur_cuda.launch_plan(S, n, m)
    assert tuple(got) == plan
    assert (got.panel, got.cols) == schur_cuda.launch_shape(n, m)
    assert schur_cuda._smem_bytes(n, got.panel, got.cols, got.small_m) <= schur_cuda._SMEM_LIMIT


def _laps_graph(laps=4, per_lap=32, seed=5):
    """tests/test_schur.py's multi-lap square loop: every node closed to its
    same-position node one lap earlier."""
    rng = np.random.default_rng(seed)
    N = laps * per_lap
    t = np.linspace(0, 2 * np.pi, per_lap, endpoint=False)
    gt = np.zeros((N, 3))
    for lap in range(laps):
        gt[lap * per_lap:(lap + 1) * per_lap, :2] = np.stack([4 * np.cos(t), 4 * np.sin(t)], 1)
    gt[:, 2] = np.tile(t + np.pi / 2, laps)
    g = jfg.empty_graph(max_priors=4, max_edges=512)
    g = jfg.add_prior(g, jnp.int32(0), jnp.array(gt[0], jnp.float32),
                      jfg.sqrt_info_from_sigmas(jnp.array([0.05, 0.05, 0.02])))
    model = jfg.sqrt_info_from_sigmas(jnp.array([0.1, 0.1, 0.05]))
    pairs = [(i, i + 1) for i in range(N - 1)] + [(i - per_lap, i) for i in range(per_lap, N)]
    for i, j in pairs:
        g = jfg.add_between(g, jnp.int32(i), jnp.int32(j), jgeom.between(jnp.array(gt[i]), jnp.array(gt[j])), model)
    init = jnp.asarray(gt + rng.normal(0, 0.05, (N, 3)), jnp.float32)
    return g, init, jnp.ones((N,), bool), gt


def test_spatial_blocks_equal_jax():
    _, init, _, gt = _laps_graph()
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=gt.shape[0]) > 0.2
    for pos, m in ((gt[:, :2], np.ones(gt.shape[0], bool)), (np.asarray(init)[:, :2], mask)):
        for shards in (2, 4, 8):
            np.testing.assert_array_equal(spatial_blocks(pos, m, shards), jspatial_blocks(pos, m, shards))


_FIXTURES = {
    "chain": lambda: chain_graph_with_closures(32, 32, n_closures=6),
    "laps": _laps_graph,
    "outlier": outlier_graph,
}
_KW = {
    "chain": dict(sep_cap=32, max_iterations=15),
    "laps": dict(sep_cap=96, max_iterations=25),
    "outlier": dict(sep_cap=32, max_iterations=30, robust_delta=2.0, rel_tol=1e-8),
}


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("fixture", ["chain", "laps", "outlier"])
def test_schur_solve_matches_jax(fixture, pallas):
    g, init, mask, gt = _FIXTURES[fixture]()
    kw = _KW[fixture]
    assign = None
    if fixture == "laps":
        assign = jspatial_blocks(gt[:, :2], np.ones(gt.shape[0], bool), 8)
    factors = [g.prior_idx, g.prior_val, g.prior_sqrt_info, g.prior_mask,
               g.edge_idx, g.edge_meas, g.edge_sqrt_info, g.edge_mask]
    jp, jsep, _ = jschur_solve(
        jmake_mesh(8), init, mask, *factors, None if assign is None else jnp.asarray(assign),
        pallas_elimination=pallas, pallas_interpret=True, **kw,
    )
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tp, tsep, iters = schur_solve(
        make_mesh(8, "cpu"), t(init), t(mask), *[t(f) for f in factors],
        None if assign is None else t(assign), pallas_elimination=pallas, **kw,
    )
    assert tsep == int(jsep) > 0
    assert 1 <= iters <= kw["max_iterations"]
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
