"""Distributed tests on the 8-device CPU mesh (SURVEY.md §4.2.5): sharded
Schur BA must match single-device BA; multi-sequence DP tracking must match
per-sequence tracking."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from boslam_tpu.config import CameraConfig, LocalBaConfig, OrbConfig, SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.parallel import make_mesh
from boslam_tpu.parallel.sharded_ba import (
    make_sharded_ba, shard_edges_by_point, stripe_points,
)
from boslam_tpu.solvers import ba_core

from tests.test_local_ba import CFG as BA_CFG, make_ba_problem


def test_mesh_axes():
    mesh = make_mesh(8, seq=2)
    assert mesh.shape["seq"] == 2 and mesh.shape["pt"] == 4


def test_sharded_ba_matches_single_device(rng):
    gt_poses, gt_pts, edges, n_pts = make_ba_problem(rng)
    L = BA_CFG.local_ba.max_local_points  # 64
    poses0 = se3.retract(gt_poses, jnp.asarray(
        np.concatenate([rng.normal(size=(2, 6)) * 0.03, np.zeros((2, 6))])
    ))
    pts0 = gt_pts + jnp.asarray(
        np.concatenate([rng.normal(size=(n_pts, 3)) * 0.05,
                        np.zeros((L - n_pts, 3))])
    )
    opt_mask = jnp.array([True, True])

    # --- single-device reference: same LM loop on one shard mesh ----------
    mesh1 = make_mesh(1)
    fn1 = make_sharded_ba(BA_CFG, mesh1, n_iters=12)
    e1, _ = shard_edges_by_point(edges, L, 1)
    p1, perm1 = stripe_points(pts0, 1)
    poses_a, pts_a, c0_a, c1_a = fn1(poses0, p1, e1, opt_mask)

    # --- 8-way sharded --------------------------------------------------
    mesh8 = make_mesh(8)
    fn8 = make_sharded_ba(BA_CFG, mesh8, n_iters=12)
    e8, ecap = shard_edges_by_point(edges, L, 8)
    p8, perm8 = stripe_points(pts0, 8)
    poses_b, pts_b, c0_b, c1_b = fn8(poses0, p8, e8, opt_mask)

    assert abs(float(c0_a) - float(c0_b)) < 1e-2 * max(float(c0_a), 1.0)
    assert abs(float(c1_a) - float(c1_b)) < 0.05 * max(float(c1_a), 1e-3) + 1e-3
    dr, dt = se3.pose_distance(
        jnp.asarray(np.asarray(poses_a[:2])), jnp.asarray(np.asarray(poses_b[:2]))
    )
    assert float(jnp.max(dt)) < 1e-3
    assert float(jnp.max(dr)) < 1e-3
    # Points converge to groundtruth on both paths.
    gt_p8 = np.asarray(gt_pts)[perm8]
    used = np.arange(L)[perm8] < n_pts
    err = np.linalg.norm(np.asarray(pts_b) - gt_p8, axis=-1)[used]
    assert err.max() < 5e-3


def test_sharded_ba_converges(rng):
    """Sharded solve drives the cost to ~zero (exact synthetic problem)."""
    gt_poses, gt_pts, edges, n_pts = make_ba_problem(rng)
    L = BA_CFG.local_ba.max_local_points
    poses0 = se3.retract(gt_poses, jnp.asarray(
        np.concatenate([rng.normal(size=(2, 6)) * 0.02, np.zeros((2, 6))])
    ))
    pts0 = gt_pts + jnp.asarray(
        np.concatenate([rng.normal(size=(n_pts, 3)) * 0.03,
                        np.zeros((L - n_pts, 3))])
    )
    opt_mask = jnp.array([True, True])
    mesh8 = make_mesh(8)
    fn8 = make_sharded_ba(BA_CFG, mesh8, n_iters=15)
    e8, _ = shard_edges_by_point(edges, L, 8)
    p8, _ = stripe_points(pts0, 8)
    _, _, c0, c1 = fn8(poses0, p8, e8, opt_mask)
    assert float(c1) < 1e-3 * max(float(c0), 1.0)


CAM = CameraConfig(width=160, height=120, fx=70.0, fy=70.0, cx=80.0, cy=60.0)
DP_CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=128, n_levels=3))


@pytest.mark.slow
def test_batched_engine_matches_single_engine():
    """BatchedSlamSystem (config 5: whole fused frame step shard_mapped over
    'seq') reproduces the single-sequence engine's trajectories."""
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel.multi import run_sequences, seq_mesh
    from boslam_tpu.slam import run_sequence

    cfg = DP_CFG
    frame_lists, single = [], []
    for seed in (0, 1):
        traj = synthetic.orbit_trajectory(
            12, radius=0.25 + 0.05 * seed, yaw_amplitude=0.1
        )
        frames = synthetic.render_sequence(CAM, traj)
        frame_lists.append(frames)
        single.append(run_sequence(cfg, frames, async_mapping=False))

    eng = run_sequences(cfg, frame_lists, mesh=seq_mesh(2))
    for s in range(2):
        ts_b, est_b = eng.trajectory(s)
        ts_a, est_a = single[s].trajectory()
        np.testing.assert_allclose(est_b, est_a, atol=1e-3)
        assert eng.n_keyframes(s) == single[s].n_keyframes


@pytest.mark.slow
def test_distributed_global_ba_matches_single(rng):
    """Distributed global BA on a LIVE tracked map (edges sharded over 'pt',
    psum Schur) matches the single-device solver (VERDICT r1 item 1: real
    map-derived edge list, state produced by tracking)."""
    from boslam_tpu.config import MapConfig
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel.sharded_global_ba import distributed_global_ba
    from boslam_tpu.slam import run_sequence
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    cfg = SlamConfig(
        camera=CAM, orb=OrbConfig(n_features=128, n_levels=3),
        map=MapConfig(max_keyframes=16, max_points=2048),
    )
    traj = synthetic.orbit_trajectory(15, radius=0.3, yaw_amplitude=0.15)
    frames = synthetic.render_sequence(CAM, traj)
    slam = run_sequence(cfg, frames)
    assert slam.n_keyframes >= 2

    st_a, stats = global_bundle_adjustment(cfg, slam.map, lm_iters=5, cg_iters=30)
    mesh = make_mesh(8, seq=1)
    st_b, (c0, c1, n_edges) = distributed_global_ba(
        cfg, mesh, slam.map, lm_iters=5, cg_iters=30
    )
    assert int(n_edges) == int(stats.n_edges) and int(n_edges) > 100
    assert abs(float(c0) - float(stats.cost0)) < 1e-2 * max(float(stats.cost0), 1.0)
    assert float(c1) < float(c0)
    dr, dt = se3.pose_distance(st_a.kf_pose, st_b.kf_pose)
    kv = np.asarray(slam.map.kf_valid)
    assert float(jnp.max(jnp.where(jnp.asarray(kv), dt, 0.0))) < 2e-3
    # Landmarks land in the same place on both paths.
    pv = np.asarray(slam.map.pt_valid)
    perr = np.linalg.norm(
        np.asarray(st_a.pt_xyz) - np.asarray(st_b.pt_xyz), axis=-1
    )[pv]
    assert perr.max() < 5e-3


@pytest.mark.slow
def test_batched_engine_depth_stride_matches_single_engine():
    """With depth_wire_stride > 1 the batched feed must subsample depth the
    same way the single engine does — full-res depth would be indexed at
    uv/stride and read the wrong quadrant (advisor r2 / VERDICT weak 5)."""
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel.multi import run_sequences, seq_mesh
    from boslam_tpu.slam import run_sequence
    import dataclasses

    cfg = DP_CFG.replace(
        camera=dataclasses.replace(DP_CFG.camera, depth_wire_stride=2)
    )
    frame_lists, single = [], []
    for seed in (0, 1):
        traj = synthetic.orbit_trajectory(6, radius=0.25 + 0.05 * seed)
        frames = synthetic.render_sequence(CAM, traj)
        frame_lists.append(frames)
        single.append(run_sequence(cfg, frames, async_mapping=False))

    eng = run_sequences(cfg, frame_lists, mesh=seq_mesh(2))
    for s in range(2):
        _, est_b = eng.trajectory(s)
        _, est_a = single[s].trajectory()
        np.testing.assert_allclose(est_b, est_a, atol=1e-3)
        assert eng.n_points(s) == single[s].n_points


def test_distributed_runtime_smoke():
    """jax.distributed.initialize single-process smoke (SURVEY §5.8 /
    VERDICT r2 item 2): the bootstrap path exists and runs — coordinator
    service + barrier — without a cluster.  Subprocess so the runtime
    doesn't latch onto the test process."""
    import os
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import os;"
        "os.environ['BOSLAM_COORDINATOR']='localhost:47123';"
        "os.environ['BOSLAM_NUM_PROCESSES']='1';"
        "os.environ['BOSLAM_PROCESS_ID']='0';"
        "from boslam_tpu.parallel.distributed import maybe_initialize,"
        " runtime_info;"
        "assert maybe_initialize(), 'initialize failed';"
        "info = runtime_info();"
        "assert info['initialized'] and info['process_count'] == 1, info;"
        "print('DIST_OK', info)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DIST_OK" in r.stdout


@pytest.mark.slow
def test_cli_distributed_global_ba(tmp_path):
    """--distributed routes the exit global BA through the landmark-sharded
    solver over the 8-device CPU mesh (VERDICT r2 item 2: distributed GBA
    reachable from the CLI)."""
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "traj.txt"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from boslam_tpu.main import main;"
        "import boslam_tpu.config as C, dataclasses;"
        "C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, width=160, height=120,"
        " fx=65.0, fy=65.0, cx=80.0, cy=60.0);"
        f"sys.argv = ['main', '--synthetic', '16', '--out', {str(out)!r},"
        " '--distributed', '--global-ba']; main()"
    )
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=8").strip(),
        # --distributed initializes the runtime and fails without a
        # cluster, so one host names itself as a one-process cluster.
        BOSLAM_COORDINATOR="localhost:47124", BOSLAM_NUM_PROCESSES="1",
        BOSLAM_PROCESS_ID="0",
    )
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=500,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "global BA sharded over pt=8" in r.stderr, r.stderr[-2000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary.get("ate_rmse_m", 1.0) < 0.05, summary


def test_batched_engine_unequal_lengths():
    """Unequal-length sequence batches (VERDICT r2 item 5): each sequence
    runs to its own end via done-masks and matches its single-engine run;
    finished sequences produce no extra records."""
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel.multi import run_sequences, seq_mesh
    from boslam_tpu.slam import run_sequence

    cfg = DP_CFG
    lengths = [12, 7]
    frame_lists, single = [], []
    for seed, n in enumerate(lengths):
        traj = synthetic.orbit_trajectory(
            n, radius=0.25 + 0.05 * seed, yaw_amplitude=0.1
        )
        frames = synthetic.render_sequence(CAM, traj)
        frame_lists.append(frames)
        single.append(run_sequence(cfg, frames, async_mapping=False))

    eng = run_sequences(cfg, frame_lists, mesh=seq_mesh(2))
    for s in range(2):
        ts_b, est_b = eng.trajectory(s)
        ts_a, est_a = single[s].trajectory()
        assert len(ts_b) == lengths[s]
        assert len(eng.metrics[s]) == lengths[s]
        np.testing.assert_allclose(est_b, est_a, atol=1e-3)
        assert eng.n_keyframes(s) == single[s].n_keyframes
