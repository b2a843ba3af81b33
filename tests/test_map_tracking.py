"""Map-state ops + end-to-end synthetic tracking (SURVEY.md §4.2.4 analog:
the minimum end-to-end slice — sequential RGBD tracking with depth-based
landmarks and motion-only BA, ATE asserted)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from boslam_tpu.config import CameraConfig, OrbConfig, SlamConfig
from boslam_tpu.features import extract_features
from boslam_tpu.features.frontend import rgb_to_gray
from boslam_tpu.geometry import align, se3
from boslam_tpu.io import synthetic
from boslam_tpu.mapping import empty_map, map_ops
from boslam_tpu.mapping.map_state import point_obs_count, recompute_covis
from boslam_tpu.tracking import init_track_state, track_frame

CAM = CameraConfig(width=320, height=240, fx=130.0, fy=130.0, cx=160.0, cy=120.0)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=256, n_levels=4))


def extract(rgb, depth):
    return extract_features(jnp.asarray(rgb_to_gray(rgb)), jnp.asarray(depth), CFG)


def no_match(n):
    return jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool)


def test_insert_first_keyframe():
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    st = empty_map(CFG)
    mp, ok = no_match(CFG.orb.n_features)
    st, _ = map_ops.insert_keyframe(CFG, st, f, se3.pose_identity(), mp, ok, 0)
    assert int(st.n_kf) == 1
    assert bool(st.kf_valid[0])
    n_pts = int(jnp.sum(st.pt_valid))
    assert n_pts > 50
    # every created point observed by KF0
    n_obs = point_obs_count(st)
    assert int(jnp.sum(n_obs > 0)) == n_pts
    # created points lie in front of the camera
    alive = np.asarray(st.pt_valid)
    assert np.asarray(st.pt_xyz)[alive, 2].min() > 0


@pytest.fixture(scope="module")
def tracked_sequence():
    """Track a 25-frame synthetic orbit, inserting keyframes per policy."""
    traj = synthetic.orbit_trajectory(25, radius=0.4, yaw_amplitude=0.15)
    frames = synthetic.render_sequence(CAM, traj)
    st = empty_map(CFG)
    track = init_track_state()
    f0 = extract(frames[0][1], frames[0][2])
    mp, ok0 = no_match(CFG.orb.n_features)
    st, _ = map_ops.insert_keyframe(CFG, st, f0, se3.pose_identity(), mp, ok0, 0)
    track = track._replace(status=jnp.asarray(1, jnp.int32))
    est = [np.asarray(se3.pose_identity())]
    kf_events = []
    for i, (ts, rgb, depth) in enumerate(frames[1:], start=1):
        f = extract(rgb, depth)
        track, out = track_frame(CFG, st, track, f)
        assert not bool(out.lost), f"lost at frame {i}"
        est.append(np.asarray(se3.pose_inv(out.pose_cw)))
        if bool(out.need_kf) and not bool(jnp.all(st.kf_valid)):
            st, kf_slot = map_ops.insert_keyframe(
                CFG, st, f, out.pose_cw, out.match_pt, out.match_ok, i
            )
            st = map_ops.fuse_new_keyframe(CFG, st, kf_slot)
            st = map_ops.cull_points(CFG, st)
            track = track._replace(
                last_kf=kf_slot, n_since_kf=jnp.zeros((), jnp.int32)
            )
            kf_events.append(i)
        st = map_ops.update_track_stats(
            CFG, st, out.visible, out.match_pt, out.match_ok
        )
    return traj, np.array(est), st, kf_events


def test_tracking_ate(tracked_sequence):
    traj, est, st, kf_events = tracked_sequence
    gt_t = traj.poses_twc[:, 4:]
    rmse, _ = align.ate_rmse(jnp.asarray(est[:, 4:]), jnp.asarray(gt_t))
    assert float(rmse) < 0.02, f"ATE {float(rmse):.4f} m"


def test_keyframes_inserted(tracked_sequence):
    _, _, st, kf_events = tracked_sequence
    assert int(st.n_kf) >= 2, "no keyframes beyond KF0"
    # covisibility between consecutive keyframes is strong
    if int(st.n_kf) >= 2:
        assert int(st.covis[0, 1]) > 10
        assert int(st.spanning_parent[1]) == 0


def test_cull_points_removes_unobserved():
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    st = empty_map(CFG)
    mp, ok = no_match(CFG.orb.n_features)
    st, _ = map_ops.insert_keyframe(CFG, st, f, se3.pose_identity(), mp, ok, 0)
    # Simulate: all points predicted visible many times but never found.
    st = st._replace(
        pt_n_vis=jnp.where(st.pt_valid, 10, 0), pt_n_found=jnp.zeros_like(st.pt_n_found)
    )
    st2 = map_ops.cull_points(CFG, st)
    assert int(jnp.sum(st2.pt_valid)) == 0
    assert int(jnp.sum(st2.kf_obs_pt >= 0)) == 0


def test_keyframe_slot_reuse():
    """Culled keyframe slots are reclaimed: with capacity C, >C insertions
    keep succeeding as long as culling frees slots (VERDICT r1 item 3)."""
    from boslam_tpu.config import MapConfig
    from boslam_tpu.mapping.map_state import free_kf_slot, latest_kf_slot

    cfg = CFG.replace(map=MapConfig(max_keyframes=8, max_points=4096))
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    st = empty_map(cfg)
    mp, ok = no_match(cfg.orb.n_features)
    slots = []
    for i in range(20):
        assert not bool(jnp.all(st.kf_valid)), f"no free slot at insertion {i}"
        st, slot = map_ops.insert_keyframe(
            cfg, st, f, se3.pose_identity(), mp, ok, i
        )
        slots.append(int(slot))
        # Manually retire an old keyframe once near capacity (stand-in for
        # cull_one_keyframe) so the free list is exercised.
        if int(jnp.sum(st.kf_valid)) >= 6:
            victim_seq = jnp.where(st.kf_valid & (st.kf_seq > 0), st.kf_seq, 1 << 30)
            victim = int(jnp.argmin(victim_seq))
            st = st._replace(
                kf_valid=st.kf_valid.at[victim].set(False),
                kf_obs_pt=st.kf_obs_pt.at[victim].set(-1),
            )
    assert int(st.n_kf) == 20                      # monotonic counter
    assert max(slots) < 8                          # slots stay in capacity
    assert len(set(slots)) < len(slots)            # reuse actually happened
    assert int(latest_kf_slot(st)) == slots[-1]
    assert int(st.kf_seq[slots[-1]]) == 19
    # Root slot 0 still valid with seq 0 (gauge anchor untouched).
    assert bool(st.kf_valid[0]) and int(st.kf_seq[0]) == 0


def test_update_track_stats_scatter():
    st = empty_map(CFG)
    n = CFG.orb.n_features
    mp = jnp.full((n,), -1, jnp.int32).at[0].set(5).at[1].set(5).at[2].set(7)
    ok = jnp.zeros(n, bool).at[0].set(True).at[1].set(True).at[2].set(True)
    vis = jnp.zeros(CFG.map.max_points, bool).at[5].set(True).at[7].set(True)
    st = map_ops.update_track_stats(CFG, st, vis, mp, ok)
    assert int(st.pt_n_found[5]) == 2
    assert int(st.pt_n_found[7]) == 1
    assert int(st.pt_n_vis[5]) == 1
    assert int(st.pt_n_vis[0]) == 0


def test_map_state_shapes_chex():
    """chex structural assertions on the MapState pytree (SURVEY §5.2)."""
    import chex

    st = empty_map(CFG)
    K, P, N = CFG.map.max_keyframes, CFG.map.max_points, CFG.orb.n_features
    chex.assert_shape(st.kf_pose, (K, 7))
    chex.assert_shape(st.kf_desc, (K, N, 8))
    chex.assert_shape(st.kf_obs_pt, (K, N))
    chex.assert_shape(st.pt_xyz, (P, 3))
    chex.assert_shape(st.covis, (K, K))
    chex.assert_type(st.kf_desc, jnp.uint32)
    chex.assert_type(st.kf_seq, jnp.int32)
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    chex.assert_shape(f.desc, (CFG.orb.n_features, 8))
    chex.assert_tree_all_finite((f.uv, f.xyz, f.depth))
    mp, ok = no_match(CFG.orb.n_features)
    st2, slot = map_ops.insert_keyframe(CFG, st, f, se3.pose_identity(), mp, ok, 0)
    chex.assert_trees_all_equal_shapes(st, st2)
    chex.assert_tree_all_finite(st2.pt_xyz)


def test_cull_keyframe_rehomes_spanning_and_loop_edges():
    """Culling a keyframe must leave NO stale references to its slot:
    children's spanning_parent re-homes to the victim's parent, and loop
    edges touching the victim are invalidated — otherwise free-list slot
    reuse lets build_essential_edges rigidly constrain an unrelated new
    keyframe with a stale stored measurement (advisor r2, high)."""
    from boslam_tpu.solvers.pose_graph import add_loop_edge, build_essential_edges

    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    st = empty_map(CFG)
    mp0, ok0 = no_match(CFG.orb.n_features)
    st, s0 = map_ops.insert_keyframe(CFG, st, f, se3.pose_identity(), mp0, ok0, 0)
    # KF1..KF4 re-observe KF0's points => every point seen 5x => any interior
    # keyframe is redundant.
    shared = st.kf_obs_pt[s0]
    ok = shared >= 0
    for i in range(1, 5):
        st, _ = map_ops.insert_keyframe(
            CFG, st, f, se3.pose_identity(), shared, ok, i
        )
    # Manufacture the hazard: KF2's spanning parent is KF1; a loop edge and a
    # spanning child (KF3) also reference KF1.
    st = st._replace(
        spanning_parent=st.spanning_parent
        .at[1].set(0).at[2].set(1).at[3].set(1).at[4].set(3)
    )
    st = add_loop_edge(st, jnp.asarray(4), jnp.asarray(1), se3.pose_identity())
    assert int(st.n_loop_edges) == 1

    st2, cull_info = map_ops.cull_one_keyframe(CFG, st)
    victim = int(np.flatnonzero(np.asarray(st.kf_valid) & ~np.asarray(st2.kf_valid))[0])
    assert victim == 1  # first eligible (root + latest protected)
    # Cull record: victim identity + pose relative to its parent (KF0).
    ci = np.asarray(cull_info)
    assert int(ci[0]) == victim and int(ci[2]) == 0
    assert np.allclose(ci[4:11], np.asarray(se3.pose_identity()), atol=1e-6)
    # Children re-homed to the victim's parent (KF0); victim's entry cleared.
    sp = np.asarray(st2.spanning_parent)
    assert sp[2] == 0 and sp[3] == 0
    assert sp[1] == -1
    # Loop edge touching the victim is dead and stays dead in the essential
    # graph even after the slot is reused.
    assert np.asarray(st2.loop_edges)[0].tolist() == [-1, -1]
    st3, reused = map_ops.insert_keyframe(
        CFG, st2, f, se3.pose_identity(), shared, ok, 5
    )
    assert int(reused) == victim  # the slot actually got reused
    edges = build_essential_edges(CFG, st3)
    K = st3.kf_pose.shape[0]
    lp_valid = np.asarray(edges.valid)[-st3.loop_edges.shape[0]:]
    assert not lp_valid[0]
    # And no spanning edge claims the reused slot as a stale parent.
    sp_i = np.asarray(edges.i[:K])
    sp_j = np.asarray(edges.j[:K])
    sp_v = np.asarray(edges.valid[:K])
    for c in (2, 3):
        if sp_v[c]:
            assert sp_j[c] == 0, f"child {c} still parented to reused slot"


WHOLE_MAP_P = 32768  # a whole-map match at relocalization scale


def test_relocalize_global_path_large_map():
    """Relocalization before the vocabulary exists matches the frame
    against the whole 32768-point map (VERDICT r2 item 10) and recovers the
    pose."""
    from boslam_tpu.config import MapConfig
    from boslam_tpu.loopclosure import empty_loop_state
    from boslam_tpu.tracking import relocalize
    from boslam_tpu.tracking.tracker import ST_OK

    cfg = CFG.replace(
        map=MapConfig(max_keyframes=16, max_points=WHOLE_MAP_P)
    )
    pose = np.array([1.0, 0, 0, 0, 0.05, 0.0, 0.1])
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f0 = extract(rgb, depth)
    st = empty_map(cfg)
    mp, ok0 = no_match(cfg.orb.n_features)
    st, _ = map_ops.insert_keyframe(cfg, st, f0, se3.pose_identity(), mp, ok0, 0)
    # Frame from a nearby pose; tracker is LOST with a stale pose guess.
    rgb1, depth1 = synthetic.render_frame(CAM, pose)
    f1 = extract_features(
        jnp.asarray(rgb_to_gray(rgb1)), jnp.asarray(depth1), cfg
    )
    track = init_track_state()._replace(status=jnp.asarray(2, jnp.int32))
    ls = empty_loop_state(cfg)  # vocab not trained -> global match path
    new_track, good, n_inl = relocalize(
        cfg, st, ls, track, f1, jax.random.key(0)
    )
    assert bool(good), f"relocalization failed ({int(n_inl)} inliers)"
    assert int(new_track.status) == ST_OK
    est = np.asarray(se3.pose_inv(new_track.pose_cw))
    np.testing.assert_allclose(est[4:], pose[4:], atol=0.02)


def test_global_match_whole_map_is_plain_jnp():
    """The tracker's whole-map match at P=32768 lowers to plain XLA ops (no
    custom kernel) and equals the same pipeline built on the exact popcount
    Hamming matrix."""
    from boslam_tpu.config import MapConfig
    from boslam_tpu.matching import hamming, rotation
    from boslam_tpu.tracking.tracker import global_match

    cfg = CFG.replace(map=MapConfig(max_keyframes=16, max_points=WHOLE_MAP_P))
    rgb, depth = synthetic.render_frame(CAM, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    f = extract(rgb, depth)
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, (WHOLE_MAP_P, 8), dtype=np.uint32)
    src = rng.integers(0, f.desc.shape[0], 2048)
    desc[:2048] = np.asarray(f.desc)[src]
    angle = np.zeros(WHOLE_MAP_P, np.float32)
    angle[:2048] = np.asarray(f.angle)[src]
    st = empty_map(cfg)._replace(
        pt_desc=jnp.asarray(desc), pt_angle=jnp.asarray(angle),
        pt_valid=jnp.asarray(rng.random(WHOLE_MAP_P) < 0.9),
    )
    jaxpr = str(jax.make_jaxpr(lambda f, s: global_match(cfg, f, s))(f, st))
    assert "pallas_call" not in jaxpr and "custom_call" not in jaxpr
    idx, ok = jax.jit(global_match, static_argnums=0)(cfg, f, st)

    ridx, rok, _ = hamming.match_top2(
        hamming.hamming_matrix(f.desc, st.pt_desc), f.valid & f.has_depth,
        st.pt_valid, max_dist=cfg.matcher.hamming_low, ratio=0.85,
        mutual=True,
    )
    rok = rotation.rotation_consistency(
        f.angle, st.pt_angle[jnp.clip(ridx, 0, WHOLE_MAP_P - 1)], rok)
    assert int(jnp.sum(rok)) > 20
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(rok))
    np.testing.assert_array_equal(
        np.asarray(idx), np.where(np.asarray(rok), np.asarray(ridx), -1))


def test_viewing_model_gates_projection_search():
    """Map-point viewing model (VERDICT r3 item 5): oblique and out-of-band
    revisits must stop producing matches, same-viewpoint revisits must keep
    matching, and points without a model (old checkpoints) pass ungated."""
    from boslam_tpu.features.frontend import FrameFeatures
    from boslam_tpu.matching import projection

    P = CFG.map.max_points
    N = CFG.orb.n_features
    rng = np.random.default_rng(5)
    desc = jnp.asarray(rng.integers(0, 2**32, (1, 8), dtype=np.uint32))
    # One point at z=2 created from the origin at octave 0.
    st = empty_map(CFG)
    st = st._replace(
        pt_xyz=st.pt_xyz.at[0].set(jnp.array([0.0, 0.0, 2.0])),
        pt_desc=st.pt_desc.at[0].set(desc[0]),
        pt_valid=st.pt_valid.at[0].set(True),
        pt_dir_sum=st.pt_dir_sum.at[0].set(jnp.array([0.0, 0.0, -1.0])),
        pt_dmin=st.pt_dmin.at[0].set(2.0 / CFG.orb.scale_factor ** 3),
        pt_dmax=st.pt_dmax.at[0].set(2.0),
    )

    def feats_at(pose_cw):
        uv, _, _ = projection.project_points(
            CFG, pose_cw, st.pt_xyz, st.pt_valid
        )
        z = jnp.zeros((N,))
        return FrameFeatures(
            uv=jnp.zeros((N, 2)).at[0].set(uv[0]),
            xyz=jnp.zeros((N, 3)),
            depth=z,
            desc=jnp.zeros((N, 8), jnp.uint32).at[0].set(desc[0]),
            angle=jnp.zeros((N,)),
            octave=jnp.zeros((N,), jnp.int32),
            response=jnp.zeros((N,)),
            valid=jnp.zeros((N,), bool).at[0].set(True),
            has_depth=jnp.zeros((N,), bool),
        )

    def run(pose_cw, gated=True):
        f = feats_at(pose_cw)
        kw = dict(
            pt_dir_sum=st.pt_dir_sum, pt_dmin=st.pt_dmin, pt_dmax=st.pt_dmax
        ) if gated else {}
        idx, ok, vis, _ = projection.search_by_projection(
            CFG, f, pose_cw, st.pt_xyz, st.pt_desc, st.pt_valid,
            radius=10.0, max_dist=50, ratio=1.0, mutual=True, **kw
        )
        return bool(ok[0])

    # Original viewpoint: matches.
    assert run(se3.pose_identity())
    # 3x farther (dist 6 > 1.2 * dmax): distance band rejects.
    far = se3.pose_inv(jnp.array([1.0, 0, 0, 0, 0, 0, -4.0]))
    assert not run(far)
    # ... but the same pose UNGATED (no viewing model passed) still matches.
    assert run(far, gated=False)
    # Opposite side (camera at z=4 looking back): view angle rejects.
    behind = se3.pose_inv(jnp.array([0.0, 0, 1.0, 0, 0, 0, 4.0]))
    assert not run(behind)
    # A model-less point (zero dir_sum / zero dmax) passes all gates.
    st2 = st._replace(
        pt_dir_sum=st.pt_dir_sum.at[0].set(0.0),
        pt_dmin=st.pt_dmin.at[0].set(0.0),
        pt_dmax=st.pt_dmax.at[0].set(0.0),
    )
    f = feats_at(far)
    idx, ok, _, _ = projection.search_by_projection(
        CFG, f, far, st2.pt_xyz, st2.pt_desc, st2.pt_valid,
        radius=10.0, max_dist=50, ratio=1.0, mutual=True,
        pt_dir_sum=st2.pt_dir_sum, pt_dmin=st2.pt_dmin, pt_dmax=st2.pt_dmax,
    )
    assert bool(ok[0])


def test_refresh_point_model_medoid_descriptor():
    """refresh_point_model picks the min-mean-Hamming observation as the
    representative descriptor and recomputes the mean viewing direction."""
    rng = np.random.default_rng(7)
    traj = synthetic.orbit_trajectory(10, radius=0.35, yaw_amplitude=0.1)
    frames = synthetic.render_sequence(CAM, traj)
    st = empty_map(CFG)
    track = init_track_state()
    f0 = extract(frames[0][1], frames[0][2])
    mp, ok0 = no_match(CFG.orb.n_features)
    st, _ = map_ops.insert_keyframe(CFG, st, f0, se3.pose_identity(), mp, ok0, 0)
    track = track._replace(status=jnp.asarray(1, jnp.int32))
    for ts, rgb, depth in frames[1:]:
        f = extract(rgb, depth)
        track, out = track_frame(CFG, st, track, f)
        if bool(out.need_kf):
            st, slot = map_ops.insert_keyframe(
                CFG, st, f, out.pose_cw, out.match_pt, out.match_ok,
                track.frame_idx,
            )
            track = track._replace(last_kf=slot,
                                   n_since_kf=jnp.zeros((), jnp.int32))
    slot = int(track.last_kf)
    st2 = map_ops.refresh_point_model(CFG, st, jnp.asarray(slot, jnp.int32))
    alive = np.asarray(st2.pt_valid)
    # Multi-observation points got a refreshed (normalized-direction) model.
    n_obs = np.asarray(point_obs_count(st))
    multi = alive & (n_obs >= 2)
    assert multi.sum() > 10
    nrm = np.linalg.norm(np.asarray(st2.pt_dir_sum), axis=-1)
    assert np.all(nrm[multi] > 0.5)
    # Distance bands stay positive and ordered.
    assert np.all(np.asarray(st2.pt_dmax)[alive] > 0)
    assert np.all(
        np.asarray(st2.pt_dmin)[alive] <= np.asarray(st2.pt_dmax)[alive] + 1e-6
    )
    # The representative descriptor of every refreshed point is one of its
    # window observations (spot-check: descriptors are still plausible, the
    # medoid never invents bits) — check a sample point's desc appears in
    # some keyframe's descriptor table.
    pids = np.where(multi)[0][:5]
    kf_desc = np.asarray(st2.kf_desc).reshape(-1, 8)
    for p in pids:
        d = np.asarray(st2.pt_desc[p])
        assert (kf_desc == d[None, :]).all(axis=1).any()


def test_multi_candidate_relocalization_survives_alias():
    """Multi-candidate BoW relocalization (VERDICT r3 item 6): when the
    BEST-scoring BoW candidate is a texture alias (a keyframe whose BoW row
    matches perfectly but whose geometry cannot explain the frame), reloc
    must still recover via candidate #2 — and demonstrably NOT with a
    single-candidate config."""
    import dataclasses

    from boslam_tpu.config import LoopConfig
    from boslam_tpu.loopclosure import vocab as vocab_mod
    from boslam_tpu.slam import run_sequence
    from boslam_tpu.tracking import relocalize
    from boslam_tpu.tracking.tracker import ST_OK

    cfg = SlamConfig(
        camera=CAM, orb=OrbConfig(n_features=256, n_levels=4),
        loop=LoopConfig(vocab_train_kf=3),
    )
    traj = synthetic.orbit_trajectory(30, radius=0.5, yaw_amplitude=0.2)
    frames = synthetic.render_sequence(CAM, traj)
    slam = run_sequence(cfg, frames)
    assert bool(slam.loop.vocab_ready)

    # Alias keyframe: a 180-degree-turned view (sees the OPPOSITE wall, so
    # its keypoint geometry cannot relocalize any orbit frame).
    alias_twc = np.array([0.0, 0, 1.0, 0, 0.0, 0.0, 1.0])
    rgb_a, depth_a = synthetic.render_frame(CAM, alias_twc)
    f_alias = extract_features(
        jnp.asarray(rgb_to_gray(rgb_a)), jnp.asarray(depth_a), cfg
    )
    mp, ok0 = no_match(cfg.orb.n_features)
    st, alias_slot = map_ops.insert_keyframe(
        cfg, slam.map, f_alias,
        se3.pose_inv(jnp.asarray(alias_twc, jnp.float32)), mp, ok0, 999,
    )

    # Query: an early orbit frame; poison the alias keyframe's BoW row with
    # the query's own BoW vector => alias outscores every genuine candidate.
    qi = 3
    f_q = extract_features(
        jnp.asarray(rgb_to_gray(frames[qi][1])), jnp.asarray(frames[qi][2]), cfg
    )
    q_bow = vocab_mod.bow_vector(
        cfg, slam.loop.vocab, f_q.desc, f_q.valid, idf=slam.loop.idf
    )
    ls = slam.loop._replace(kf_bow=slam.loop.kf_bow.at[alias_slot].set(q_bow))
    scores = np.asarray(ls.kf_bow @ q_bow)
    assert np.argmax(np.where(np.asarray(st.kf_valid), scores, -1)) == int(
        alias_slot
    )

    track = init_track_state()._replace(status=jnp.asarray(2, jnp.int32))
    new_track, good, n_inl = relocalize(
        cfg, st, ls, track, f_q, jax.random.key(1)
    )
    assert bool(good), f"reloc failed despite genuine candidate #2 ({int(n_inl)})"
    assert int(new_track.status) == ST_OK
    est = np.asarray(se3.pose_inv(new_track.pose_cw))
    np.testing.assert_allclose(est[4:], traj.poses_twc[qi][4:], atol=0.05)

    # Control: argmax-only reloc (candidates=1) is sunk by the alias.
    cfg1 = cfg.replace(
        tracker=dataclasses.replace(cfg.tracker, reloc_candidates=1)
    )
    _, good1, _ = relocalize(cfg1, st, ls, track, f_q, jax.random.key(1))
    assert not bool(good1), "alias candidate unexpectedly relocalized"


def test_evict_for_slot_invariants():
    """Capacity-saturation eviction (SURVEY §7.2): no-op while a slot is
    free; on a full pool evicts a non-root, non-latest keyframe, records a
    valid cull-chain row, and re-homes spanning children."""
    import dataclasses

    from boslam_tpu.config import MapConfig

    cfg = SlamConfig(
        camera=CAM, orb=OrbConfig(n_features=256, n_levels=4),
        map=MapConfig(max_keyframes=6, max_points=4096),
    )
    st = empty_map(cfg)
    mp, ok = no_match(cfg.orb.n_features)
    # Fill all 6 slots from slightly different viewpoints.
    for i in range(6):
        pose = np.array([1.0, 0, 0, 0, 0.05 * i, 0, 0], np.float32)
        rgb, depth = synthetic.render_frame(cfg.camera, pose)
        f = extract_features(
            jnp.asarray(rgb_to_gray(rgb)), jnp.asarray(depth), cfg
        )
        st, _ = map_ops.insert_keyframe(
            cfg, st, f, se3.pose_inv(jnp.asarray(pose)), mp, ok, i
        )
    st = recompute_covis(st)
    assert bool(jnp.all(st.kf_valid))

    st2, info = map_ops.evict_for_slot(cfg, st)
    info = np.asarray(info)
    victim = int(info[0])
    assert victim >= 0, "full pool must evict"
    assert victim != 0, "root (gauge anchor) must never be evicted"
    latest = int(jnp.argmax(jnp.where(st.kf_valid, st.kf_seq, -1)))
    assert victim != latest, "latest keyframe must never be evicted"
    assert not bool(st2.kf_valid[victim])
    assert int(jnp.sum(st2.kf_valid)) == 5
    # Cull-chain record names a live parent (re-anchor target).
    parent = int(info[2])
    assert bool(st2.kf_valid[parent])
    # No spanning child still points at the vacated slot.
    sp = np.asarray(st2.spanning_parent)
    assert not any(
        sp[i] == victim for i in range(6) if bool(st2.kf_valid[i])
    )

    # A pool with a free slot must be a strict no-op.
    st3, info3 = map_ops.evict_for_slot(cfg, st2)
    assert int(np.asarray(info3)[0]) == -1
    assert int(jnp.sum(st3.kf_valid)) == 5
