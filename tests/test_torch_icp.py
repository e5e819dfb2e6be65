"""Port parity: dpg_slam_tpu_torch.ops.icp (the plain PyTorch ICP, the
version kernel K1 is held against) against the JAX package's XLA ICP and
its Pallas kernel run in interpret mode. (K1 itself against the plain
version runs on a card only: tests/test_torch_cuda.py.)

Tolerances:
  * plain vs JAX XLA ICP: transform atol 1e-4, converged and match counts
    equal, covariance rtol 1e-3 (atol 1e-7 for off-diagonal terms near
    zero; diagonals are ~1e-6..1e-5), fitness atol 1e-6. Same algorithm;
    the JAX path forms d2 with a matmul cross term that cancels |p|^2 ~ 25
    to ~1e-6 where the port forms dx² + dy², so a near-tied nearest
    neighbour can flip. Each source is an exact transform of its target,
    so the fitness is ~0 and only that rounding noise is compared.
  * plain vs the Pallas kernel: test_icp_pallas.py's own tolerances
    (transform atol 5e-4, fitness atol 1e-4, covariance rtol 0.05): the
    kernel forms d2 as dx² + dy² and exits per block, as the CUDA kernel
    forms d2 the same way and exits per pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpg_slam_tpu import geom as jgeom
from dpg_slam_tpu.config import PoseGraphParams as JaxPG
from dpg_slam_tpu.ops import icp as jicp
from dpg_slam_tpu.ops.icp_pallas import icp_align_pallas
from dpg_slam_tpu_torch.config import PoseGraphParams as TorchPG
from dpg_slam_tpu_torch.ops import icp as ticp
from dpg_slam_tpu_torch.ops import icp_cuda

from test_icp import make_room_scan


def _batch(B=4, seed=0, noise=0.0):
    """B room-scan pairs with known relative poses (test_icp_pallas._batch);
    `noise` perturbs the wall points, and each source is the exact
    transform of its target."""
    rng = np.random.default_rng(seed)
    tgts, srcs, poses = [], [], []
    for _ in range(B):
        tgt = make_room_scan(rng, noise=noise)
        pose = rng.uniform(-0.3, 0.3, 3)
        src = np.asarray(jgeom.inv_apply(jnp.array(pose), jnp.array(tgt)))
        tgts.append(tgt)
        srcs.append(src)
        poses.append(pose)
    mask = np.ones((B, 256), dtype=bool)
    return dict(
        src=np.stack(srcs).astype(np.float32),
        src_mask=mask.copy(),
        tgt=np.stack(tgts).astype(np.float32),
        tgt_mask=mask.copy(),
        init_guess=np.zeros((B, 3), np.float32),
    ), np.stack(poses)


def _run_both(inp, pg_kwargs=None, gate=None, pallas=False, device="cpu"):
    pg_kwargs = pg_kwargs or {}
    t_in = {k: torch.as_tensor(v, device=device) for k, v in inp.items()}
    t_gate = None if gate is None else torch.as_tensor(gate, device=device)
    got = ticp.icp_align(
        t_in["src"], t_in["src_mask"], t_in["tgt"], t_in["tgt_mask"], t_in["init_guess"],
        TorchPG(**pg_kwargs), gate_multiplier=t_gate,
    )
    j_in = [jnp.asarray(inp[k]) for k in ("src", "src_mask", "tgt", "tgt_mask", "init_guess")]
    j_gate = None if gate is None else jnp.asarray(gate)
    if pallas:
        want = icp_align_pallas(*j_in, JaxPG(**pg_kwargs), gate_multiplier=j_gate, interpret=True)
    else:
        want = jicp.icp_align(*j_in, JaxPG(**pg_kwargs), gate_multiplier=j_gate)
    return got, want


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_estimate_normals_matches_jax():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(3, 50, 2)).astype(np.float32)
    mask = rng.uniform(size=(3, 50)) > 0.25
    mask[0, :] = False
    mask[1, 10] = True  # isolated point: radial fallback
    mask[1, 9] = mask[1, 11] = False
    got = ticp.estimate_normals(torch.from_numpy(pts), torch.from_numpy(mask))
    want = jicp.estimate_normals(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize(
    "case",
    ["gn", "fixed_cov", "censi", "masked", "gate_per_pair", "no_reciprocal", "no_delta_exit"],
)
def test_plain_matches_jax_xla(case):
    inp, true_poses = _batch(B=4, seed=21, noise=0.005)
    pg, gate = {}, None
    if case == "fixed_cov":
        pg = dict(use_fixed_icp_covariance=True)
    elif case == "censi":
        pg = dict(icp_covariance_mode="censi", icp_cov_floor_transl=0.01, icp_cov_floor_rot=0.01)
    elif case == "masked":
        inp["src_mask"][:, 180:] = False
        inp["tgt_mask"][:, 200:] = False
        inp["src"][3] += 100.0  # a disjoint pair: rejected on both sides
    elif case == "gate_per_pair":
        inp["init_guess"][0] = true_poses[0] + np.array([0.9, 0.0, 0.0])
        gate = np.array([3.0, 1.0, 1.0, 2.0], np.float32)
    elif case == "no_reciprocal":
        pg = dict(icp_use_reciprocal_correspondences=False)
    elif case == "no_delta_exit":
        pg = dict(icp_error_delta_rel_tol=0.0, icp_anneal_iters=None)
    got, want = _run_both(inp, pg, gate)
    np.testing.assert_allclose(_np(got.transform), _np(want.transform), atol=1e-4)
    np.testing.assert_array_equal(_np(got.converged), _np(want.converged))
    np.testing.assert_array_equal(_np(got.num_correspondences), _np(want.num_correspondences))
    np.testing.assert_allclose(_np(got.fitness), _np(want.fitness), atol=1e-6)
    np.testing.assert_allclose(_np(got.overlap), _np(want.overlap), atol=1e-6)
    np.testing.assert_allclose(_np(got.covariance), _np(want.covariance), rtol=1e-3, atol=1e-7)
    if case == "masked":
        assert not bool(got.converged[3])


def test_plain_matches_jax_xla_fewer_sources_than_targets():
    """Ps = 64 sources against Pt = 256 targets (the DPG local registration
    aligns 256 against 2,048), at test_plain_matches_jax_xla's tolerances
    except the covariance, held per pair to 10 % of its largest entry: with
    64 sources each match carries 1/64 of the Gauss-Newton H, so one
    nearest neighbour that the JAX cross-term d2 flips (targets here lie as
    close as 6e-4 m) moves the covariance by up to 5 % of its scale (pair 2
    on this input; on 9 of 12 seeds the two agree to 1e-12). Every other
    output agrees as at Ps = Pt."""
    inp, _ = _batch(B=3, seed=23, noise=0.005)
    inp["src"] = np.ascontiguousarray(inp["src"][:, ::4])
    inp["src_mask"] = np.ascontiguousarray(inp["src_mask"][:, ::4])
    assert inp["src"].shape == (3, 64, 2) and inp["tgt"].shape == (3, 256, 2)
    got, want = _run_both(inp)
    np.testing.assert_allclose(_np(got.transform), _np(want.transform), atol=1e-4)
    np.testing.assert_array_equal(_np(got.converged), _np(want.converged))
    np.testing.assert_array_equal(_np(got.num_correspondences), _np(want.num_correspondences))
    np.testing.assert_allclose(_np(got.fitness), _np(want.fitness), atol=1e-6)
    np.testing.assert_allclose(_np(got.overlap), _np(want.overlap), atol=1e-6)
    g, w = _np(got.covariance), _np(want.covariance)
    np.testing.assert_array_less(np.abs(g - w).max(axis=(1, 2)), 0.1 * np.abs(w).max(axis=(1, 2)))
    assert _np(got.converged).all()


def test_censi_covariance_matches_jax():
    inp, true_poses = _batch(B=3, seed=22, noise=0.01)
    inp["src_mask"][:, 230:] = False
    tf = true_poses.astype(np.float32)
    kw = dict(max_correspondence_distance=0.6, reciprocal=True, src_noise_std=0.02, tgt_noise_std=0.03)
    got = ticp.censi_covariance(
        torch.from_numpy(inp["src"]), torch.from_numpy(inp["src_mask"]),
        torch.from_numpy(inp["tgt"]), torch.from_numpy(inp["tgt_mask"]), torch.from_numpy(tf), **kw,
    )
    want = jicp.censi_covariance(
        jnp.asarray(inp["src"]), jnp.asarray(inp["src_mask"]),
        jnp.asarray(inp["tgt"]), jnp.asarray(inp["tgt_mask"]), jnp.asarray(tf), **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-12)


# --- the five cases of test_icp_pallas.py, plain port vs Pallas (interpret) ---

def _check_vs_pallas(got, want, cov_atol):
    np.testing.assert_allclose(_np(got.transform), _np(want.transform), atol=5e-4)
    np.testing.assert_allclose(_np(got.fitness), _np(want.fitness), atol=1e-4)
    np.testing.assert_allclose(_np(got.covariance), _np(want.covariance), rtol=0.05, atol=cov_atol)


def test_plain_matches_pallas():
    inp, true_poses = _batch()
    got, want = _run_both(inp, pallas=True)
    _check_vs_pallas(got, want, 1e-5)
    np.testing.assert_array_equal(_np(got.converged), _np(want.converged))
    np.testing.assert_allclose(_np(got.transform), true_poses, atol=3e-2)


def test_plain_vs_pallas_masks_and_rejection():
    inp, _ = _batch(B=2, seed=3)
    inp["src"][1] += 100.0
    got, want = _run_both(inp, pallas=True)
    assert list(_np(got.converged)) == list(_np(want.converged)) == [True, False]


def test_plain_vs_pallas_gate_multiplier_per_pair():
    inp, true_poses = _batch(B=2, seed=5)
    inp["init_guess"][0] = true_poses[0] + np.array([0.9, 0, 0])
    inp["init_guess"][1] = true_poses[1]
    gate = np.array([3.0, 1.0], np.float32)
    got, want = _run_both(inp, gate=gate, pallas=True)
    np.testing.assert_allclose(_np(got.transform), _np(want.transform), atol=5e-4)
    np.testing.assert_allclose(_np(got.transform), true_poses, atol=5e-2)


def test_plain_vs_pallas_censi():
    inp, _ = _batch(B=4, seed=7)
    got, want = _run_both(inp, dict(icp_covariance_mode="censi"), pallas=True)
    _check_vs_pallas(got, want, 1e-7)
    assert np.all(np.linalg.eigvalsh(_np(got.covariance)) > 0)


def test_plain_vs_pallas_censi_masked_points():
    inp, _ = _batch(B=2, seed=9)
    inp["src_mask"][:, 200:] = False
    inp["tgt_mask"][:, 220:] = False
    got, want = _run_both(inp, dict(icp_covariance_mode="censi"), pallas=True)
    np.testing.assert_allclose(_np(got.covariance), _np(want.covariance), rtol=0.05, atol=1e-7)


def test_kernel_packing_layout():
    """The kernel's input planes: validity folded into the coordinates;
    sources and targets packed at their own counts."""
    inp, _ = _batch(B=2, seed=1)
    inp["src"] = np.ascontiguousarray(inp["src"][:, :200])
    inp["src_mask"] = np.ascontiguousarray(inp["src_mask"][:, :200])
    inp["src_mask"][0, :10] = False
    inp["tgt_mask"][1, 5:7] = False
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    normals = ticp.estimate_normals(t["tgt"], t["tgt_mask"])
    gate = torch.tensor([1.0, 3.0])
    src_planes, tgt_planes, seeds = icp_cuda.pack(
        t["src"], t["src_mask"], t["tgt"], t["tgt_mask"], normals, t["init_guess"], gate
    )
    assert src_planes.shape == (3, 2, 200) and src_planes.is_contiguous()
    assert tgt_planes.shape == (4, 2, 256) and tgt_planes.is_contiguous()
    assert torch.all(src_planes[0, 0, :10] == -1e4) and torch.all(src_planes[1, 0, :10] == -1e4)
    assert torch.all(tgt_planes[0, 1, 5:7] == 1e4) and torch.all(tgt_planes[1, 1, 5:7] == 1e4)
    assert torch.equal(src_planes[0, 1], t["src"][1, :, 0])
    assert torch.equal(tgt_planes[2], normals[..., 0]) and torch.equal(src_planes[2], t["src_mask"].float())
    assert seeds.tolist() == [[0, 0, 0, 1.0], [0, 0, 0, 3.0]]


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        icp_cuda.run_kernel(torch.zeros((3, 1, 8)), torch.zeros((4, 1, 16)), torch.zeros((1, 4)), TorchPG(),
                            censi=False)


@pytest.mark.parametrize(
    "B,Ps,Pt,want",
    [
        (9, 256, 256, 8),  # a keyframe's 1 + K pairs
        (8, 256, 2048, 8),  # the DPG local registration
        (1728, 256, 256, 1),  # the compacted reoptimize sweep
        (144, 256, 256, 4),  # batched mode at 16 sessions
        (82, 256, 256, 8),
        (100, 256, 256, 4),
        (300, 256, 256, 2),
        (4, 512, 512, 1),  # more sources than one CTA's threads
        (2, 256, 9800, 1),  # a cluster's shared memory would not fit
    ],
)
def test_kernel_launch_plan(B, Ps, Pt, want):
    """K1's cluster size for B pairs of Ps sources against Pt targets on a
    132-SM card (chip_smoke.py phase 2 measures every size the shape
    admits)."""
    assert icp_cuda.launch_plan(B, Ps, Pt, 132) == want
