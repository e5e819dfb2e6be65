"""Kernels K1 (csrc/icp_kernel.cu) and K2 (csrc/spd_solve_kernel.cu) on a
CUDA card against their plain PyTorch versions, and the port's keyframe
path, dense_pallas solve, Schur reoptimize, session-batched mode, DPG
step and experiment runner on the card against the CPU, and the
lane-axis DPG step against the one-lane step; neither the batched step loop, a DPG step nor the online
server's tick loop makes a host sync. The ordered segment sum gives the
CPU's bits on the card; repeats of the reoptimize and of solve_batched, and
the server in immediate mode against the offline stride-1 run, are equal
to the bit.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are tests/test_icp_pallas.py's (transform atol 5e-4, fitness
atol 1e-4, covariance rtol 0.05): both form d2 as dx² + dy², but the
kernel sums in another order, and each pair exits on its own where the
plain loop runs until the whole batch has frozen. K2 against
spd_solve_plain: max |X_k - X_p| <= 1e-4 max |X_p| (two blocked Cholesky
orders in float32 on damped SPD systems); K2's two factorization layouts
against each other, and K1's cluster layouts against its one-CTA layout:
equal to the bit. Card vs CPU runs of the solvers:
1e-2 m / rad, chip_smoke.py's bound for the engine.
"""

import pathlib

import numpy as np
import pytest
import torch

from dpg_slam_tpu_torch import batch, geom
from dpg_slam_tpu_torch.config import CapacityParams, DpgConfig, DpgParams, PoseGraphParams, ScanParams
from dpg_slam_tpu_torch.dpg import change_detection
from dpg_slam_tpu_torch.engine import DpgSlamEngine
from dpg_slam_tpu_torch.graph import factor_graph as fg
from dpg_slam_tpu_torch.io import dataset
from dpg_slam_tpu_torch.ops import icp, icp_cuda, schur, schur_cuda
from dpg_slam_tpu_torch.parallel import distributed_reoptimize, make_mesh
from dpg_slam_tpu_torch.utils import profiling
from dpg_slam_tpu_torch.utils.checkpoint import load_checkpoint, state_from_numpy, state_to_numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _launches(kernel: str) -> int:
    """Launches of kernel K1 ("k1") or K2 ("k2") so far, by the package's
    counters (utils.profiling)."""
    return profiling.counters().get(f"{kernel}.launches", 0)


def _room_batch(B, seed, noise=0.005, n=256):
    """B pairs of points on the walls of an 8x6 room; each source is the
    target seen from a random pose within ±0.3 (m, rad)."""
    rng = np.random.default_rng(seed)
    tgts, poses = [], []
    for _ in range(B):
        t = rng.uniform(0, 4, n)
        side = rng.integers(0, 4, n)
        x = np.where(side < 2, t * 2 - 4, np.where(side == 2, -4.0, 4.0))
        y = np.where(side == 0, -3.0, np.where(side == 1, 3.0, t * 1.5 - 3))
        tgts.append(np.stack([x, y], 1) + rng.normal(0, noise, (n, 2)))
        poses.append(rng.uniform(-0.3, 0.3, 3))
    tgt = torch.tensor(np.stack(tgts), dtype=torch.float32)
    pose = torch.tensor(np.stack(poses), dtype=torch.float32)
    src = geom.inv_apply(pose, tgt)
    mask = torch.ones((B, n), dtype=torch.bool)
    return src, mask, tgt, mask.clone(), torch.zeros((B, 3)), pose


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gn", "censi_masked", "gate_per_pair", "large_batch"])
def test_kernel_matches_plain_on_card(cuda, case):
    B = 1024 if case == "large_batch" else 9
    src, smask, tgt, tmask, seeds, true_pose = _room_batch(B, seed=31)
    pg = PoseGraphParams()
    gate = torch.full((B,), pg.icp_coarse_gate_multiplier)
    if case == "censi_masked":
        pg = PoseGraphParams(icp_covariance_mode="censi")
        smask[:, 200:] = False
        tmask[:, 220:] = False
    elif case == "gate_per_pair":
        seeds = true_pose + torch.tensor([0.5, 0.0, 0.0])
    elif case == "large_batch":
        gate[:] = 1.0
        seeds = true_pose + 0.05
    args = [x.to(cuda) for x in (src, smask, tgt, tmask, seeds)] + [pg]
    kw = dict(
        tgt_normals=icp.estimate_normals(args[2], args[3]), gate_multiplier=gate.to(cuda),
        min_correspondences=10, fitness_threshold=0.25, min_overlap=pg.icp_min_overlap,
        sensor_noise_std=pg.icp_sensor_noise_std,
    )
    before = _launches("k1")
    ker = icp.icp_align(*args, **kw)  # dispatches to K1 on a CUDA tensor
    torch.cuda.synchronize()
    assert _launches("k1") == before + 1
    ref = icp.icp_align_plain(*args, **kw)
    np.testing.assert_allclose(ker.transform.cpu(), ref.transform.cpu(), atol=5e-4)
    np.testing.assert_allclose(ker.fitness.cpu(), ref.fitness.cpu(), atol=1e-4)
    agree = (ker.converged == ref.converged).float().mean().item()
    assert agree >= (0.999 if B > 100 else 1.0)
    both = (ker.converged == ref.converged).cpu()
    np.testing.assert_allclose(
        ker.covariance.cpu()[both], ref.covariance.cpu()[both], rtol=0.05, atol=1e-7
    )
    if case != "censi_masked":
        np.testing.assert_allclose(ker.transform.cpu(), true_pose, atol=5e-2)


@pytest.mark.cuda
def test_kernel_matches_plain_fewer_sources_than_targets(cuda):
    """The DPG local registration's shape: 8 pairs of 256 sources against
    2,048 targets, at test_kernel_matches_plain_on_card's tolerances."""
    B = 8
    src, smask, tgt, tmask, _, true_pose = _room_batch(B, seed=37, n=2048)
    src, smask = src[:, ::8].contiguous(), smask[:, ::8].contiguous()
    seeds = true_pose + 0.05
    pg = PoseGraphParams()
    args = [x.to(cuda) for x in (src, smask, tgt, tmask, seeds)] + [pg]
    kw = dict(
        tgt_normals=icp.estimate_normals(args[2], args[3]), gate_multiplier=torch.ones(B, device=cuda),
        min_correspondences=10, fitness_threshold=0.25, min_overlap=pg.icp_min_overlap,
        sensor_noise_std=pg.icp_sensor_noise_std,
    )
    before = _launches("k1")
    ker = icp.icp_align(*args, **kw)
    torch.cuda.synchronize()
    assert _launches("k1") == before + 1
    ref = icp.icp_align_plain(*args, **kw)
    np.testing.assert_allclose(ker.transform.cpu(), ref.transform.cpu(), atol=5e-4)
    np.testing.assert_allclose(ker.fitness.cpu(), ref.fitness.cpu(), atol=1e-4)
    assert torch.equal(ker.converged, ref.converged) and bool(ker.converged.all())
    np.testing.assert_allclose(ker.covariance.cpu(), ref.covariance.cpu(), rtol=0.05, atol=1e-7)
    np.testing.assert_allclose(ker.transform.cpu(), true_pose, atol=5e-2)


def _packed(cuda, case):
    """K1's packed inputs for one of the bit-equality cases: 9 pairs
    (Gauss-Newton, or Censi with masked points) or 8 pairs of 256 sources
    against 2,048 targets."""
    pg = PoseGraphParams(icp_covariance_mode="censi") if case == "censi_masked" else PoseGraphParams()
    if case == "local_reg":
        src, smask, tgt, tmask, _, true_pose = _room_batch(8, seed=37, n=2048)
        src, smask, seeds = src[:, ::8].contiguous(), smask[:, ::8].contiguous(), true_pose + 0.05
    else:
        src, smask, tgt, tmask, seeds, _ = _room_batch(9, seed=31)
        if case == "censi_masked":
            smask[:, 200:] = False
            tmask[:, 220:] = False
    src, smask, tgt, tmask, seeds = (x.to(cuda) for x in (src, smask, tgt, tmask, seeds))
    gate = torch.full((src.shape[0],), pg.icp_coarse_gate_multiplier, device=cuda)
    return icp_cuda.pack(src, smask, tgt, tmask, icp.estimate_normals(tgt, tmask), seeds, gate), pg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gn", "censi_masked", "local_reg"])
def test_kernel_clusters_equal_one_cta_to_the_bit(cuda, case):
    """Every cluster size gives the one-CTA layout's (B, 24) rows to the
    bit: min is exact and the sums run in the same order (see the kernel
    source)."""
    packed, pg = _packed(cuda, case)
    rows = {C: icp_cuda.run_kernel(*packed, pg, icp.is_censi_mode(pg), cluster=C) for C in icp_cuda.CLUSTERS}
    torch.cuda.synchronize()
    for C in (2, 4, 8):
        assert torch.equal(rows[C], rows[1]), C


@pytest.mark.cuda
def test_kernel_launch_plan_launches(cuda):
    packed, pg = _packed(cuda, "gn")
    _, B, Ps = packed[0].shape
    plan = icp_cuda.launch_plan(B, Ps, packed[1].shape[2], torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan > 1
    before = _launches("k1")
    planned = icp_cuda.run_kernel(*packed, pg, False)
    forced = icp_cuda.run_kernel(*packed, pg, False, cluster=plan)
    torch.cuda.synchronize()
    assert _launches("k1") == before + 2
    assert torch.equal(planned, forced) and bool(torch.isfinite(planned).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_cluster(cuda):
    packed, pg = _packed(cuda, "gn")
    for C in (3, 16):
        with pytest.raises(ValueError, match="cluster"):
            icp_cuda.run_kernel(*packed, pg, False, cluster=C)
    wide = (torch.zeros((3, 2, 300), device=cuda), torch.zeros((4, 2, 300), device=cuda), torch.zeros((2, 4), device=cuda))
    with pytest.raises(ValueError, match="Ps = 300"):
        icp_cuda.run_kernel(*wide, pg, False, cluster=2)
    assert icp_cuda.launch_plan(2, 300, 300, 132) == 1


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    src_planes, tgt_planes = torch.zeros((3, 2, 8), device=cuda), torch.zeros((4, 2, 16), device=cuda)
    pg = PoseGraphParams()
    with pytest.raises(ValueError, match="seeds"):
        icp_cuda.run_kernel(src_planes, tgt_planes, torch.zeros((3, 4), device=cuda), pg, censi=False)
    with pytest.raises(ValueError, match="float32"):
        icp_cuda.run_kernel(src_planes.double(), tgt_planes, torch.zeros((2, 4), device=cuda), pg, censi=False)
    with pytest.raises(ValueError, match="target planes"):
        icp_cuda.run_kernel(src_planes, tgt_planes[:, :1], torch.zeros((2, 4), device=cuda), pg, censi=False)
    with pytest.raises(ValueError, match="Ps = 8, Pt = 12000"):
        icp_cuda.run_kernel(src_planes, torch.zeros((4, 2, 12000), device=cuda), torch.zeros((2, 4), device=cuda), pg,
                            censi=False)


@pytest.mark.cuda
def test_keyframe_path_on_card_matches_cpu(cuda):
    cfg = DpgConfig(
        scan=ScanParams(num_beams=256),
        pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=30, max_loop_closures_per_node=4),
        capacity=CapacityParams(max_nodes=64, max_edges=512, max_priors=8),
    )
    seq = dataset.simulate_sequence(
        dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan,
        step=0.5, seed=1, odom_noise_transl=0.02, odom_noise_rot=0.008,
    )
    runs = []
    for device in (cuda, "cpu"):
        eng = DpgSlamEngine(cfg, device)
        kfs = []
        for t in range(len(seq.scans)):
            eng.observe_odometry(seq.odometry[t])
            if eng.observe_laser(seq.scans[t]):
                kfs.append(t)
        runs.append((kfs, eng.trajectory(), int(eng.state.graph.num_edges)))
    (kg, tg, eg), (kc, tc, ec) = runs
    assert kg == kc and eg == ec
    np.testing.assert_allclose(tg, tc, atol=1e-2)


def _spd_batch(S, n, m, pad, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n, n))
    H = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    if pad:
        H[:, -pad:, :] = 0.0
        H[:, :, -pad:] = 0.0
        H[:, np.arange(n - pad, n), np.arange(n - pad, n)] = 1.0
    B = rng.normal(size=(S, n, m))
    return torch.tensor(H, dtype=torch.float32), torch.tensor(B, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,m,pad", [(4, 192, 385, 0), (1, 768, 1, 0), (1, 192, 1, 0), (3, 128, 7, 5)])
def test_spd_kernel_matches_plain_on_card(cuda, S, n, m, pad):
    H, B = (x.to(cuda) for x in _spd_batch(S, n, m, pad))
    before = _launches("k2")
    X = schur.spd_solve(H, B)
    torch.cuda.synchronize()
    assert _launches("k2") == before + 1
    ref = schur.spd_solve_plain(H, B)
    assert (X - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    if pad:  # identity rows pass B through
        torch.testing.assert_close(X[:, -pad:], B[:, -pad:], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,m", [(1, 768, 1), (1, 512, 3)])
def test_spd_multi_cta_factor_equals_single(cuda, S, n, m):
    """The many-CTA factorization leaves the one-CTA factor to the bit (each
    element's sums run in the same order), and the same solution."""
    H, B = (x.to(cuda) for x in _spd_batch(S, n, m, 0))
    out = {}
    for layout in ("single", "multi"):
        X, work = torch.empty_like(B), torch.empty_like(H)
        schur_cuda.run_kernel(H, B, X, work, layout)
        out[layout] = (X, work.tril())
    torch.cuda.synchronize()
    assert schur_cuda.launch_plan(S, n, m).factorization == "multi"
    assert torch.equal(out["single"][1], out["multi"][1])
    assert torch.equal(out["single"][0], out["multi"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [192, 300])
@pytest.mark.parametrize("m", [1, 7, 31])
def test_spd_few_columns_match_plain_on_card(cuda, n, m):
    """The warp-per-column substitution (m < 32), after the one-CTA
    (n = 192) and the many-CTA (n = 300) factorization, against
    spd_solve_plain at the K2 tolerance; padded slots pass B through."""
    H, B = (x.to(cuda) for x in _spd_batch(2, n, m, 3))
    plan = schur_cuda.launch_plan(2, n, m)
    assert plan.small_m and plan.factorization == ("single" if n == 192 else "multi")
    X = schur.spd_solve(H, B)
    torch.cuda.synchronize()
    ref = schur.spd_solve_plain(H, B)
    assert (X - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    torch.testing.assert_close(X[:, -3:], B[:, -3:], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_spd_kernel_rejects_bad_inputs(cuda):
    H, B = _spd_batch(2, 64, 3, 0)
    with pytest.raises(ValueError, match="CUDA"):
        schur_cuda.spd_solve_cuda(H, B)
    H, B = H.to(cuda), B.to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        schur_cuda.spd_solve_cuda(H.transpose(1, 2), B)
    with pytest.raises(ValueError, match="float32"):
        schur_cuda.spd_solve_cuda(H.double(), B.double())
    with pytest.raises(ValueError, match="match"):
        schur_cuda.spd_solve_cuda(H, B[:, :10])


@pytest.mark.cuda
def test_dense_pallas_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    N = 64
    gt = np.cumsum(rng.normal(0.5, 0.1, size=(N, 3)) * [1, 0.2, 0.05], axis=0)
    pairs = np.array([(i, i + 1) for i in range(N - 1)] + [(0, 20), (10, 40), (25, 63)], np.int32)
    meas = torch.tensor(np.stack([gt[j] - gt[i] for i, j in pairs]), dtype=torch.float32)
    init = torch.tensor(gt + rng.normal(0, 0.05, size=(N, 3)), dtype=torch.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = fg.empty_graph(4, 256, dev)
        g = fg.add_prior(g, 0, torch.zeros(3, device=dev), fg.sqrt_info_from_sigmas(torch.full((3,), 0.01, device=dev)))
        si = fg.sqrt_info_from_sigmas(torch.tensor([0.1, 0.1, 0.05], device=dev)).expand(len(pairs), 3, 3)
        p = torch.as_tensor(pairs, device=dev)
        g = fg.add_between_batch(g, p[:, 0], p[:, 1], meas.to(dev), si, torch.ones(len(pairs), dtype=torch.bool, device=dev))
        before = _launches("k2")
        poses, _ = fg.solve(init.to(dev), g, torch.ones(N, dtype=torch.bool, device=dev),
                            method="dense_pallas", max_iterations=15)
        assert (_launches("k2") > before) == (dev.type == "cuda")
        out.append(poses.cpu())
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_schur_reoptimize_on_card_matches_cpu(cuda):
    cfg = DpgConfig(
        scan=ScanParams(num_beams=256),
        pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=20, max_loop_closures_per_node=3),
        capacity=CapacityParams(max_nodes=64, max_edges=512, max_priors=8),
    )
    seq = dataset.simulate_sequence(
        dataset.make_office_world(), dataset.office_loop_waypoints(), cfg.scan,
        step=0.5, seed=1, odom_noise_transl=0.02, odom_noise_rot=0.008,
    )
    eng = DpgSlamEngine(cfg, "cpu")
    for t in range(len(seq.scans)):
        eng.observe_odometry(seq.odometry[t])
        eng.observe_laser(seq.scans[t])
    flat = state_to_numpy(eng.state)
    out = []
    for dev in (cuda, torch.device("cpu")):
        state = state_from_numpy(flat, cfg, dev)
        before = _launches("k2")
        new = distributed_reoptimize(make_mesh(4, dev), cfg, state, solver="schur", pallas_elimination=True)
        assert (_launches("k2") > before) == (dev.type == "cuda")
        out.append(new.poses[: eng.num_nodes()].cpu())
    d = (out[0] - out[1]).abs()
    d[:, 2] = torch.remainder(d[:, 2] + np.pi, 2 * np.pi) - np.pi
    assert d.abs().max().item() <= 1e-2


# --- the session-batched mode on the card -------------------------------------

def _batched_setup(n_sessions, scans_per_session, full_width=False):
    """A config and n_sessions simulated office sessions (seeds 11, 12, ...):
    test size, or the bench's full width (bench_assets/keyframe)."""
    if full_width:
        import pathlib

        cfg = DpgConfig.from_json(
            (pathlib.Path(__file__).parent.parent / "bench_assets" / "keyframe" / "config.json").read_text()
        )
    else:
        cfg = DpgConfig(
            scan=ScanParams(num_beams=256, range_max=10.0),
            pose_graph=PoseGraphParams(icp_max_points=64, icp_maximum_iterations=30, max_loop_closures_per_node=4),
            capacity=CapacityParams(max_nodes=64, max_edges=512, max_priors=8),
        )
    world, wps = dataset.make_office_world(), dataset.office_loop_waypoints()
    seqs = [dataset.simulate_sequence(world, wps, cfg.scan, step=0.5, seed=11 + i,
                                      odom_noise_transl=0.02, odom_noise_rot=0.008)
            for i in range(n_sessions)]
    return cfg, [(s.odometry[:scans_per_session], s.scans[:scans_per_session]) for s in seqs]


def _batched_loop(cfg, sessions, device, method="lanes_chol"):
    """(states, steps, bucket, method) ready for batch._process_sessions_batched."""
    steps, _, bucket, method = batch._schedule(cfg, sessions, None, method, 1)
    states = batch._stack_states(cfg, len(sessions), device)
    return states, [torch.as_tensor(x, device=device) for x in steps], bucket, method


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lanes_chol", "lanes_cg"])
def test_batched_step_loop_makes_no_host_sync(cuda, method):
    """At S = 4 the step loop runs with sync debug mode set to "error": any
    host read inside a step raises."""
    cfg, sessions = _batched_setup(4, 40)
    states, steps, bucket, method = _batched_loop(cfg, sessions, cuda, method)
    batch._process_sessions_batched(cfg, states, *steps, method, bucket)  # first use: handles, constants
    states, steps, bucket, method = _batched_loop(cfg, sessions, cuda, method)
    torch.cuda.synchronize()
    before = _launches("k1")
    torch.cuda.set_sync_debug_mode("error")
    try:
        states = batch._process_sessions_batched(cfg, states, *steps, method, bucket)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches("k1") - before == steps[0].shape[0]  # one K1 launch a step
    assert (states.num_nodes.cpu() > 3).all()


@pytest.mark.cuda
def test_batched_lanes_on_card_match_cpu(cuda):
    cfg, sessions = _batched_setup(3, 80)
    runs = [batch.process_sessions_batched(cfg, sessions, device=d) for d in (cuda, "cpu")]
    (sg, cg), (sc, cc) = runs
    assert cg == cc
    for i, n in enumerate(cg):
        lg, lc = batch.session_state(sg, i), batch.session_state(sc, i)
        edges = (int(lg.graph.num_edges), int(lc.graph.num_edges))
        assert int(lg.num_nodes) == int(lc.num_nodes) == n
        assert edges[0] == edges[1], f"lane {i}: edges {edges}"
        np.testing.assert_allclose(lg.poses[:n].cpu().numpy(), lc.poses[:n].numpy(), atol=1e-2, err_msg=f"lane {i}")


@pytest.mark.cuda
def test_kernel_matches_plain_on_a_batched_step(cuda):
    """K1 on the fused pairs of a real batched step at full width (16
    sessions, K = 8: 144 pairs of 256 points; the last step of one office
    lap, where loop closures are live), against the plain version."""
    cfg, sessions = _batched_setup(16, None, full_width=True)
    states, steps, bucket, method = _batched_loop(cfg, sessions, cuda)
    calls = []
    real = icp.icp_align

    def capture(*args, **kwargs):
        # Copies: inside the loop the pairs are the keyframe graphs'
        # buffers, which every step rewrites.
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                      {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    icp.icp_align = capture
    try:
        batch._process_sessions_batched(cfg, states, *steps, method, bucket)
    finally:
        icp.icp_align = real
    args, kw = max(calls, key=lambda c: c[0][3].any(1).sum().item())  # the step with the most live pairs
    assert args[0].shape == (144, 256, 2) and args[3].any(1).sum().item() > 16
    pg = args[5]
    kw = dict(kw, min_correspondences=10, fitness_threshold=0.25, min_overlap=pg.icp_min_overlap,
              sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    ref = icp.icp_align_plain(*args, **kw)
    torch.testing.assert_close(ker.transform, ref.transform, rtol=0, atol=5e-4)
    torch.testing.assert_close(ker.fitness, ref.fitness, rtol=0, atol=1e-4)
    both = ker.converged == ref.converged
    assert both.float().mean().item() >= 0.99 and ker.converged.any()
    torch.testing.assert_close(ker.covariance[both], ref.covariance[both], rtol=0.05, atol=1e-7)


SESSION = pathlib.Path(__file__).parent.parent / "bench_assets" / "session"


@pytest.mark.cuda
def test_dpg_step_on_card_matches_cpu(cuda):
    """One execute_dpg on bench_assets/session (full width: 1,024 beams, a
    1024² window, M = 32, local registration on) on the card against the
    CPU, within chip_smoke.py phase 10a's bounds (0.1 % of the label and
    sector entries; node_active and the contributor count equal); the step
    launches K1 once and reads no host value."""
    cfg = load_checkpoint(SESSION, "cpu").config
    cpu = load_checkpoint(SESSION, "cpu").state
    gpu = load_checkpoint(SESSION, cuda).state
    change_detection.execute_dpg(cfg, gpu)  # first use: constants
    torch.cuda.synchronize()
    before = _launches("k1")
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_new, g_info = change_detection.execute_dpg(cfg, gpu)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches("k1") == before + 1
    c_new, c_info = change_detection.execute_dpg(cfg, cpu)
    n = int(cpu.num_nodes)
    assert (g_new.labels[:n].cpu() != c_new.labels[:n]).sum().item() <= 1e-3 * n * cfg.scan.num_beams
    assert (g_new.sector_active[:n].cpu() != c_new.sector_active[:n]).sum().item() <= 1e-3 * n * cfg.dpg.num_sectors
    assert torch.equal(g_new.node_active.cpu(), c_new.node_active)
    assert int(g_info.num_contributors) == int(c_info.num_contributors) > 0
    assert abs(float(g_info.coverage) - float(c_info.coverage)) <= 1e-3


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_dpg_batch(cuda):
    """K1 on the DPG local registration's batch captured from a step on
    bench_assets/session (5 chain scans of 256 points against 2,048 submap
    points, 12 iterations) against the plain version; every cluster size
    gives the one-CTA rows to the bit."""
    eng = load_checkpoint(SESSION, cuda)
    calls = []
    real = icp.icp_align

    def capture(*args, **kwargs):
        # Copies: inside the loop the pairs are the keyframe graphs'
        # buffers, which every step rewrites.
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                      {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    icp.icp_align = capture
    try:
        change_detection.execute_dpg(eng.config, eng.state)
    finally:
        icp.icp_align = real
    (args, kw), = calls
    assert args[0].shape == (5, 256, 2) and args[2].shape == (5, 2048, 2)
    pg = args[5]
    assert pg.icp_maximum_iterations == 12
    normals = icp.estimate_normals(args[2], args[3])
    kw = dict(kw, tgt_normals=normals, min_correspondences=10, fitness_threshold=0.25,
              min_overlap=pg.icp_min_overlap, sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    ref = icp.icp_align_plain(*args, **kw)
    torch.testing.assert_close(ker.transform, ref.transform, rtol=0, atol=5e-4)
    torch.testing.assert_close(ker.fitness, ref.fitness, rtol=0, atol=1e-4)
    both = ker.converged == ref.converged
    assert both.all() and ker.converged.any()
    torch.testing.assert_close(ker.covariance[both], ref.covariance[both], rtol=0.05, atol=1e-7)
    packed = icp_cuda.pack(*args[:4], normals, args[4], kw["gate_multiplier"])
    assert icp_cuda.launch_plan(5, 256, 2048, torch.cuda.get_device_properties(cuda).multi_processor_count) > 1
    one = icp_cuda.run_kernel(*packed, pg, False, cluster=1)
    for C in icp_cuda.CLUSTERS[1:]:
        assert torch.equal(icp_cuda.run_kernel(*packed, pg, False, cluster=C), one), C


def _session_lanes(device, S):
    """S lanes of bench_assets/session, lane i cut to its first 220 - 7i
    nodes (every chain still in pass 1)."""
    flat = state_to_numpy(load_checkpoint(SESSION, "cpu").state)
    flat = {k: np.stack([v] * S) for k, v in flat.items()}
    flat["num_nodes"] = flat["num_nodes"] - 7 * np.arange(S, dtype=flat["num_nodes"].dtype)
    return state_from_numpy(flat, load_checkpoint(SESSION, "cpu").config, device, lanes=S)


@pytest.mark.cuda
def test_lane_dpg_step_on_card_matches_one_lane(cuda):
    """execute_dpg_lanes on 4 lanes of bench_assets/session on the card:
    one K1 launch and no host read for all lanes, and each lane within
    chip_smoke.py phase 10a's bounds of the one-lane step on that lane."""
    cfg = load_checkpoint(SESSION, "cpu").config
    lanes = _session_lanes(cuda, 4)
    change_detection.execute_dpg_lanes(cfg, lanes)  # first use: constants
    torch.cuda.synchronize()
    before = _launches("k1")
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, info = change_detection.execute_dpg_lanes(cfg, lanes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches("k1") == before + 1
    for i in range(4):
        one, one_info = change_detection.execute_dpg(cfg, batch.session_state(lanes, i))
        n = int(lanes.num_nodes[i])
        assert (new.labels[i, :n] != one.labels[:n]).sum().item() <= 1e-3 * n * cfg.scan.num_beams
        assert (new.sector_active[i, :n] != one.sector_active[:n]).sum().item() <= 1e-3 * n * cfg.dpg.num_sectors
        assert torch.equal(new.node_active[i], one.node_active)
        assert int(info.num_contributors[i]) == int(one_info.num_contributors) > 0
        assert abs(float(info.coverage[i]) - float(one_info.coverage)) <= 1e-3


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_lane_dpg_batch(cuda):
    """K1 on the lane-axis DPG step's batch of 8 lanes of bench_assets/session
    (40 chain scans of 256 points against each lane's 2,048 submap points,
    12 iterations) against the plain version; every cluster size the plan
    admits gives the one-CTA rows to the bit."""
    cfg = load_checkpoint(SESSION, "cpu").config
    lanes = _session_lanes(cuda, 8)
    calls = []
    real = icp.icp_align

    def capture(*args, **kwargs):
        # Copies: inside the loop the pairs are the keyframe graphs'
        # buffers, which every step rewrites.
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                      {k: v.clone() if torch.is_tensor(v) else v for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    icp.icp_align = capture
    try:
        change_detection.execute_dpg_lanes(cfg, lanes)
    finally:
        icp.icp_align = real
    (args, kw), = calls
    assert args[0].shape == (40, 256, 2) and args[2].shape == (40, 2048, 2)
    pg = args[5]
    normals = icp.estimate_normals(args[2], args[3])
    kw = dict(kw, tgt_normals=normals, min_correspondences=10, fitness_threshold=0.25,
              min_overlap=pg.icp_min_overlap, sensor_noise_std=pg.icp_sensor_noise_std)
    ker = icp_cuda.icp_align_cuda(*args, **kw)
    ref = icp.icp_align_plain(*args, **kw)
    torch.testing.assert_close(ker.transform, ref.transform, rtol=0, atol=5e-4)
    torch.testing.assert_close(ker.fitness, ref.fitness, rtol=0, atol=1e-4)
    both = ker.converged == ref.converged
    assert both.all() and ker.converged.any()
    torch.testing.assert_close(ker.covariance[both], ref.covariance[both], rtol=0.05, atol=1e-7)
    packed = icp_cuda.pack(*args[:4], normals, args[4], kw["gate_multiplier"])
    one = icp_cuda.run_kernel(*packed, pg, False, cluster=1)
    for C in icp_cuda.CLUSTERS[1:]:
        assert torch.equal(icp_cuda.run_kernel(*packed, pg, False, cluster=C), one), C


# --- reproducible sums and the online server on the card ----------------------

def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_segment_sum_on_card_equals_cpu(cuda):
    """The ordered segment sum gives the CPU's bits on the card (each row
    one sequential sum in the same order), with no host sync, in both plan
    forms (a segment per row; a segment per value where rows outnumber
    values)."""
    from dpg_slam_tpu_torch.graph.segment import segment_plan, segment_sum

    rng = np.random.default_rng(8)
    for tail, n in (((3, 3), 256), ((3,), 256), ((3, 3), 100_000)):
        vals = torch.from_numpy((rng.normal(size=(4096,) + tail) * 10.0 ** rng.uniform(-4, 4, (4096,) + tail))
                                .astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, n * 200 // 256, 4096))
        want = segment_sum(vals, segment_plan(idx, n))
        v, i = vals.to(cuda), idx.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = segment_sum(v, segment_plan(i, n))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _same_bits(got.cpu(), want)


@pytest.mark.cuda
def test_reoptimize_repeats_to_the_bit_on_card(cuda):
    """Two engine reoptimizes of bench_assets/session give the same bits."""
    runs = []
    for _ in range(2):
        eng = load_checkpoint(SESSION, cuda)
        eng.increment_pass()
        runs.append([eng.state.poses, *eng.state.graph])
    for a, b in zip(*runs):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["chol", "cg_fixed"])
def test_solve_batched_repeats_to_the_bit_on_card(cuda, method):
    """solve_batched twice on the lanes graph of a batched run, from
    perturbed poses: the same bits."""
    cfg, sessions = _batched_setup(4, 60)
    states, counts = batch.process_sessions_batched(cfg, sessions, device=cuda)
    rng = np.random.default_rng(9)
    init = states.poses + torch.tensor(rng.normal(0, 0.05, states.poses.shape), dtype=torch.float32, device=cuda)
    mask = torch.arange(init.shape[1], device=cuda)[None] < states.num_nodes[:, None]
    pg = cfg.pose_graph
    kw = dict(max_iterations=5, damping_init=pg.gn_damping_init, method=method, cg_iterations=12,
              robust_delta=pg.robust_delta, terminate_on_reject=True, rel_tol=1e-4)
    (p1, s1), (p2, s2) = (fg.solve_batched(init, states.graph, mask, **kw) for _ in range(2))
    assert _same_bits(p1, p2) and torch.equal(s1.iterations, s2.iterations)
    assert (s1.iterations > 0).all()


def _server_ticks(sessions, T):
    return (np.stack([o[:T] for o, _ in sessions], axis=1), np.stack([s[:T] for _, s in sessions], axis=1))


@pytest.mark.cuda
def test_server_tick_loop_makes_no_host_sync(cuda):
    """observe x T and flush with sync debug mode set to "error" (after a
    warm server): the pending buffers go up without a host sync."""
    cfg, sessions = _batched_setup(4, 60)
    odo, scn = _server_ticks(sessions, 60)
    warm = batch.BatchedSlamServer(cfg, 4, device=cuda)
    for t in range(20):
        warm.observe(odo[t], scn[t])
    warm.flush()
    srv = batch.BatchedSlamServer(cfg, 4, device=cuda)
    before = _launches("k1")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(len(odo)):
            srv.observe(odo[t], scn[t])
        srv.flush()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _launches("k1") - before == srv.steps_executed < srv.keyframes_executed
    assert min(srv.num_nodes(i) for i in range(4)) >= 10


@pytest.mark.cuda
def test_server_immediate_matches_offline_on_card(cuda):
    """The server in immediate mode against process_sessions_batched at
    stride 1 (same bucket and method) on the card: per lane, every state
    leaf equal to the bit."""
    cfg, sessions = _batched_setup(3, 60)
    odo, scn = _server_ticks(sessions, 60)
    srv = batch.BatchedSlamServer(cfg, 3, min_batch_fraction=1e-9, device=cuda)
    for t in range(len(odo)):
        srv.observe(odo[t], scn[t])
    srv.flush()
    off, counts = batch.process_sessions_batched(cfg, sessions, solve_bucket=srv.bucket, solve_method=srv.method,
                                                 device=cuda)
    for i, n in enumerate(counts):
        assert srv.num_nodes(i) == n
        got, want = (state_to_numpy(batch.session_state(x, i)) for x in (srv.states, off))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"lane {i}: {k}")


# --- the keyframe loop replayed from CUDA graphs ------------------------------

GRAPH_COUNTERS = ("batch.keyframe_graph_captures", "batch.keyframe_graph_replays", "batch.steps")


def _graph_job(cuda, job):
    """(run, keyframe loops a call) of the graph test's job: "batched", a
    loop of 4 lanes at stride 4; "multipass", two passes of 2 lanes at
    stride 4 with the DPG step after every pass-1 step (a box moves
    between the passes)."""
    if job == "batched":
        cfg, sessions = _batched_setup(4, 60)
        return lambda: batch.process_sessions_batched(cfg, sessions, solve_stride=4, device=cuda), 1
    cfg = DpgConfig(
        scan=ScanParams(num_beams=128),
        pose_graph=PoseGraphParams(icp_max_points=32, icp_maximum_iterations=10, max_loop_closures_per_node=2),
        dpg=DpgParams(grid_extent_cells=128, occ_grid_resolution=0.1, max_submap_nodes=4, local_reg_max_points=256),
        capacity=CapacityParams(max_nodes=64, max_edges=256, max_priors=4),
    )
    def session(lane, p, box):
        seq = dataset.simulate_sequence(dataset.make_office_world().add_box(*box), dataset.office_loop_waypoints(),
                                        cfg.scan, step=0.25, seed=10 * lane + p, odom_noise_transl=0.02,
                                        odom_noise_rot=0.008)
        return seq.odometry[:48], seq.scans[:48]

    boxes = ((2.0, 1.5, 1.0, 1.0), (-3.0, 1.5, 1.0, 1.0))
    lane_passes = [[session(lane, p, box) for p, box in enumerate(boxes)] for lane in range(2)]
    return lambda: batch.process_sessions_multipass(cfg, lane_passes, solve_stride=4, device=cuda), 2


def _state_leaves(states):
    return [x for f in states for x in (f if hasattr(f, "_fields") else (f,))]


def _leaf_names(states):
    return [f"{f}.{g}" if g else f for f, x in zip(states._fields, states)
            for g in (x._fields if hasattr(x, "_fields") else (None,))]


def _stage_calls(monkeypatch):
    """Counts of batch._lanes_keyframe's calls ("steps") and of the
    engine._top_k_ascending ("top_k") and ops.icp.icp_align ("align")
    calls made inside them, each wrapped by its module name."""
    calls = {"steps": 0, "top_k": 0, "align": 0}
    inside = [False]
    real_step = batch._lanes_keyframe

    def step(*a, **k):
        calls["steps"] += 1
        inside[0] = True
        try:
            return real_step(*a, **k)
        finally:
            inside[0] = False

    def counted(real, key):
        def call(*a, **k):
            calls[key] += inside[0]
            return real(*a, **k)
        return call

    monkeypatch.setattr(batch, "_lanes_keyframe", step)
    monkeypatch.setattr(batch.eng, "_top_k_ascending", counted(batch.eng._top_k_ascending, "top_k"))
    monkeypatch.setattr(icp, "icp_align", counted(icp.icp_align, "align"))
    return calls


def _counted(run, calls):
    """run() with the change of the graph counters and of the stage calls."""
    c0, s0 = profiling.counters(), dict(calls)
    states, _ = run()
    torch.cuda.synchronize()
    c1 = profiling.counters()
    return states, {k: c1.get(k, 0) - c0.get(k, 0) for k in GRAPH_COUNTERS}, {k: calls[k] - s0[k] for k in calls}


@pytest.mark.cuda
@pytest.mark.parametrize("job", ["batched", "multipass"])
def test_keyframe_graphs_replay_the_eager_step_to_the_bit(cuda, monkeypatch, job):
    """The keyframe loop on the card with its step replayed from CUDA
    graphs, against the same job run eagerly (the break-even step count
    put out of reach): every field of the returned states, graph
    included, equal to the bit; one capture per keyframe loop and a
    replay every later step; the candidate sort and the ICP call made by
    their module names once per step; and a second call leaves the first
    call's states as they were."""
    run, loops = _graph_job(cuda, job)
    calls = _stage_calls(monkeypatch)
    first, counts, staged = _counted(run, calls)
    kept = [x.clone() for x in _state_leaves(first)]
    steps = counts["batch.steps"]
    assert steps >= 6 * loops
    assert counts["batch.keyframe_graph_captures"] == loops
    assert counts["batch.keyframe_graph_replays"] == steps - loops
    assert staged == {"steps": steps, "top_k": steps, "align": steps}
    second, _, _ = _counted(run, calls)
    for a, b in zip(_state_leaves(first), kept, strict=True):
        assert _same_bits(a, b)  # the second call wrote nothing of the first's
    assert all(_same_bits(a, b) for a, b in zip(_state_leaves(first), _state_leaves(second), strict=True))
    monkeypatch.setattr(batch, "_GRAPH_MIN_STEPS", 1 << 30)
    eager, counts, staged = _counted(run, calls)
    assert counts == {"batch.keyframe_graph_captures": 0, "batch.keyframe_graph_replays": 0, "batch.steps": steps}
    assert staged == {"steps": steps, "top_k": steps, "align": steps}
    for field, a, b in zip(_leaf_names(first), _state_leaves(first), _state_leaves(eager), strict=True):
        assert _same_bits(a, b), field


@pytest.mark.cuda
@pytest.mark.parametrize("offline", [False, True])
def test_runner_on_card_matches_cpu(cuda, offline):
    """dpg_slam_tpu_torch.run at a small config (two box_change passes at
    128 beams) on the card and on the CPU: keyframes per pass equal,
    poses within 1e-2 m / rad."""
    from dpg_slam_tpu_torch import run

    argv = ["--num-beams", "128", "--max-nodes", "128", "--passes", "2"] + (["--offline"] if offline else [])
    card, card_eng = run.run(run.parse_args(argv))
    cpu, cpu_eng = run.run(run.parse_args([*argv, "--device", "cpu"]))
    assert card["device"]["type"] == "cuda" and card_eng.device.type == "cuda"
    assert [p["keyframes"] for p in card["passes"]] == [p["keyframes"] for p in cpu["passes"]]
    d = card_eng.trajectory() - cpu_eng.trajectory()
    d[:, 2] = np.angle(np.exp(1j * d[:, 2]))
    assert np.abs(d).max() <= 1e-2
