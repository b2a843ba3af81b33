"""Frame-to-map tracking (reference tracking.py, SURVEY.md §2.1/§3.2).

Per-frame pose estimation as ONE jitted megafunction: constant-velocity
motion-model prediction, projection-window matching against the whole map
(one masked Hamming matmul instead of per-point candidate lists), robust
GN motion-only BA, then a wider track-local-map second pass and
re-optimization.  Data-dependent *decisions* (keyframe? lost?) are
returned as scalars for the thin host loop; all data-dependent *compute*
stays masked on device (SURVEY.md §7.0).

Relocalization (the lost path, §3.2) matches globally (no window) and solves
3D-3D RANSAC — the reference's BoW-candidate + PnP fallback.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.matching import hamming, projection, rotation
from boslam_tpu.solvers import optimize_pose, ransac_pnp, ransac_se3

ST_UNINIT, ST_OK, ST_LOST = 0, 1, 2


class TrackState(NamedTuple):
    pose_cw: jnp.ndarray    # [7] current camera pose (world -> camera)
    velocity: jnp.ndarray   # [7] T_cw(t) ∘ T_cw(t-1)^-1 (motion model)
    status: jnp.ndarray     # scalar i32: 0 uninit / 1 ok / 2 lost
    n_since_kf: jnp.ndarray # scalar i32 frames since last keyframe
    last_kf: jnp.ndarray    # scalar i32 reference keyframe id
    frame_idx: jnp.ndarray  # scalar i32


class TrackOut(NamedTuple):
    pose_cw: jnp.ndarray
    match_pt: jnp.ndarray   # [N] i32 matched map-point id per keypoint (-1)
    match_ok: jnp.ndarray   # [N] bool final inlier matches
    visible: jnp.ndarray    # [P] bool map points predicted visible this frame
    n_inliers: jnp.ndarray  # scalar i32
    n_visible: jnp.ndarray  # scalar i32 map points predicted visible
    n_matches: jnp.ndarray  # scalar i32 pre-BA matches
    need_kf: jnp.ndarray    # scalar bool keyframe-decision hint
    lost: jnp.ndarray       # scalar bool
    # One packed device->host readback: [n_inliers, n_matches, n_visible,
    # need_kf, lost] as f32 — the host loop fetches ONLY this (one transfer
    # instead of five).
    scalars: jnp.ndarray


def init_track_state() -> TrackState:
    return TrackState(
        pose_cw=se3.pose_identity(),
        velocity=se3.pose_identity(),
        status=jnp.asarray(ST_UNINIT, jnp.int32),
        n_since_kf=jnp.zeros((), jnp.int32),
        last_kf=jnp.zeros((), jnp.int32),
        frame_idx=jnp.zeros((), jnp.int32),
    )


def _local_point_mask(map_state, last_kf):
    """Points observed by the reference keyframe's covisibility
    neighborhood, two rings deep (the reference's local tracking map,
    SURVEY.md §3.2 track_local_map)."""
    K = map_state.kf_valid.shape[0]
    P = map_state.pt_valid.shape[0]
    self_row = jnp.arange(K) == last_kf
    nb1 = ((map_state.covis[last_kf] > 0) | self_row) & map_state.kf_valid
    nb2 = ((map_state.covis @ nb1.astype(jnp.int32)) > 0) | nb1
    nb2 = nb2 & map_state.kf_valid
    obs = map_state.kf_obs_pt                                  # [K, N]
    sel = nb2[:, None] & map_state.kf_kp_valid & (obs >= 0)
    ids = jnp.where(sel, obs, P)  # P = out of range -> dropped
    return jnp.zeros((P,), bool).at[ids.reshape(-1)].set(True, mode="drop")


def _match_and_optimize(cfg, feats, pose_pred, map_state, pt_mask,
                        radius, max_dist, ratio):
    idx, ok, vis, _ = projection.search_by_projection(
        cfg, feats, pose_pred, map_state.pt_xyz, map_state.pt_desc,
        pt_mask, radius=radius, max_dist=max_dist, ratio=ratio,
        pt_angle=map_state.pt_angle,
        pt_dir_sum=map_state.pt_dir_sum,
        pt_dmin=map_state.pt_dmin,
        pt_dmax=map_state.pt_dmax,
    )
    P = map_state.pt_xyz.shape[0]
    pid = jnp.clip(idx, 0, P - 1)
    pts_w = map_state.pt_xyz[pid]
    res = optimize_pose(
        cfg, pose_pred, pts_w, feats.uv, feats.depth,
        feats.has_depth & ok, ok, feats.octave,
    )
    return idx, ok, res, vis


@functools.partial(jax.jit, static_argnums=(0,))
def track_frame(cfg: SlamConfig, map_state, track: TrackState, feats):
    """Track one frame against the map.  Returns (TrackState, TrackOut)."""
    tk = cfg.tracker
    mc = cfg.matcher
    pose_pred = se3.pose_compose(track.velocity, track.pose_cw)

    if tk.track_scope == "local":
        pt_mask = map_state.pt_valid & _local_point_mask(
            map_state, track.last_kf
        )
    else:
        pt_mask = map_state.pt_valid

    # Pass 1: tight window from motion model.
    idx1, ok1, res1, vis1 = _match_and_optimize(
        cfg, feats, pose_pred, map_state, pt_mask,
        mc.search_radius, mc.hamming_low, mc.ratio,
    )
    # Fallback: if too few matches, widen (reference's lost-motion-model
    # path).  lax.cond so the expensive wide pass only runs when needed.
    few = jnp.sum(ok1) < 2 * tk.min_inliers

    def wide_pass(_):
        idx1b, ok1b, res1b, _ = _match_and_optimize(
            cfg, feats, pose_pred, map_state, pt_mask,
            mc.search_radius_wide, mc.hamming_high, mc.ratio,
        )
        return idx1b, ok1b, res1b.pose

    def keep(_):
        return idx1, ok1, res1.pose

    idx1, ok1, pose1 = jax.lax.cond(few, wide_pass, keep, None)

    # Pass 2: track local map — refined pose, fresh window, re-optimize.
    idx2, ok2, res2, vis2 = _match_and_optimize(
        cfg, feats, pose1, map_state, pt_mask,
        mc.search_radius, mc.hamming_high, 1.0,
    )
    pose = res2.pose
    inl = res2.inliers
    n_inl = res2.n_inliers
    n_match = jnp.sum(ok2)

    lost = n_inl < tk.min_inliers
    # Keep the old pose when lost (motion model would drift).
    pose = jnp.where(lost, track.pose_cw, pose)
    velocity = jnp.where(
        lost, se3.pose_identity(), se3.pose_compose(pose, se3.pose_inv(track.pose_cw))
    )

    # Keyframe policy (reference need_new_keyframe()).
    ref_obs = jnp.sum(
        (map_state.kf_obs_pt[track.last_kf] >= 0) & map_state.kf_kp_valid[track.last_kf]
    )
    tracked_ratio = n_inl / jnp.maximum(ref_obs, 1)
    need_kf = (
        ~lost
        & (track.n_since_kf >= tk.kf_min_interval)
        & (
            (track.n_since_kf >= tk.kf_max_interval)
            | (tracked_ratio < tk.kf_tracked_ratio)
            | (n_inl < tk.kf_min_tracked)
        )
    )

    new_track = TrackState(
        pose_cw=pose,
        velocity=velocity,
        status=jnp.where(lost, ST_LOST, ST_OK).astype(jnp.int32),
        n_since_kf=track.n_since_kf + 1,
        last_kf=track.last_kf,
        frame_idx=track.frame_idx + 1,
    )
    out = TrackOut(
        pose_cw=pose,
        match_pt=jnp.where(inl, idx2, -1),
        match_ok=inl & (idx2 >= 0),
        visible=vis2,
        n_inliers=n_inl,
        n_visible=jnp.sum(vis2),
        n_matches=n_match,
        need_kf=need_kf,
        lost=lost,
        scalars=jnp.stack(
            [
                n_inl.astype(jnp.float32),
                n_match.astype(jnp.float32),
                jnp.sum(vis2).astype(jnp.float32),
                need_kf.astype(jnp.float32),
                lost.astype(jnp.float32),
            ]
        ),
    )
    return new_track, out


def _reloc_solve(cfg: SlamConfig, pts_w, feats, idx, ok, key):
    """Shared tail of relocalization: RANSAC PnP (2D-reprojection-scored
    consensus, hypotheses from depth-backed minimal sets — the reference's
    solvePnPRansac role) + robust GN refine."""
    res = ransac_pnp(
        cfg, pts_w, feats.uv, feats.xyz, feats.has_depth, ok, key,
        n_hypotheses=cfg.tracker.ransac_iters,
        min_inliers=cfg.tracker.min_inliers,
    )
    refined = optimize_pose(
        cfg, res.pose, pts_w, feats.uv, feats.depth,
        feats.has_depth & ok, ok, feats.octave, inliers0=res.inliers,
    )
    good = res.ok & (refined.n_inliers >= cfg.tracker.min_inliers)
    return good, refined.pose, refined.n_inliers


def global_match(cfg: SlamConfig, feats, map_state):
    """Whole-map brute-force match of the frame against every map point (no
    projection window): one [N, P] Hamming matrix, mutual ratio-tested
    top-2, then rotation consistency.  Returns (idx [N] i32 point id or -1,
    ok [N] bool)."""
    P = map_state.pt_xyz.shape[0]
    dist = hamming.hamming_matrix_mxu(feats.desc, map_state.pt_desc)
    idx, ok, _ = hamming.match_top2(
        dist, feats.valid & feats.has_depth, map_state.pt_valid,
        max_dist=cfg.matcher.hamming_low, ratio=0.85, mutual=True,
    )
    ok = rotation.rotation_consistency(
        feats.angle, map_state.pt_angle[jnp.clip(idx, 0, P - 1)], ok,
    )
    return jnp.where(ok, idx, -1), ok


@functools.partial(jax.jit, static_argnums=(0,))
def relocalize(cfg: SlamConfig, map_state, loop_state, track: TrackState,
               feats, key):
    """Relocalization (reference relocalize() via BoW candidates + PnP, §3.2
    lost path).

    With a trained vocabulary: query the BoW database for the top-R
    candidate keyframes (reference: a candidate SET, §3.2), match the
    frame's descriptors into each bucketed by vocabulary word (reference
    ``search_by_bow``), lift matches to the keyframes' map points
    (backprojected depth where no point is bound), and solve 3D-3D RANSAC +
    robust GN for ALL candidates in one vmapped dispatch — the best
    verified candidate wins, so an aliased-texture top score cannot sink
    the frame.  Before the vocabulary exists: brute-force the whole point
    cloud (cold-start fallback).
    """
    from boslam_tpu.matching import bow as bow_mod
    from boslam_tpu.loopclosure import vocab as vocab_mod

    P = map_state.pt_xyz.shape[0]
    K = map_state.kf_pose.shape[0]
    R = cfg.tracker.reloc_candidates
    N = feats.desc.shape[0]

    def bow_path(_):
        frame_bow = vocab_mod.bow_vector(
            cfg, loop_state.vocab, feats.desc, feats.valid,
            idf=loop_state.idf,
        )
        scores = loop_state.kf_bow @ frame_bow
        _, cands = jax.lax.top_k(
            jnp.where(map_state.kf_valid, scores, -1.0), R
        )

        def one(cand):
            # Depthless frame keypoints can match too: the PnP consensus is
            # reprojection-scored, so they vote without a 3D backprojection.
            idx, ok, _ = bow_mod.search_by_bow(
                loop_state.vocab, feats.desc, feats.valid,
                map_state.kf_desc[cand],
                map_state.kf_kp_valid[cand] & (map_state.kf_depth[cand] > 0),
                max_dist=cfg.matcher.hamming_high, ratio=0.9,
                angle_a=feats.angle, angle_b=map_state.kf_angle[cand],
            )
            # World points of the matched keyframe slots: bound map point
            # where one exists, else the keypoint's depth backprojection.
            j = jnp.clip(idx, 0, N - 1)
            obs = map_state.kf_obs_pt[cand][j]
            from boslam_tpu.geometry import camera as cam_mod
            xc = cam_mod.backproject(
                cfg.camera, map_state.kf_uv[cand][j],
                map_state.kf_depth[cand][j],
            )
            xw_bp = se3.pose_apply(
                se3.pose_inv(map_state.kf_pose[cand])[None], xc
            )
            has_pt = obs >= 0
            pts_w = jnp.where(
                has_pt[:, None],
                map_state.pt_xyz[jnp.clip(obs, 0, P - 1)], xw_bp,
            )
            return pts_w, idx, ok

        return jax.vmap(one)(cands)

    def global_path(_):
        idx, ok = global_match(cfg, feats, map_state)
        pts1 = map_state.pt_xyz[jnp.clip(idx, 0, P - 1)]
        # One real candidate; pad to the R-wide batch with masked rows.
        pts_r = jnp.broadcast_to(pts1[None], (R, N, 3))
        idx_r = jnp.broadcast_to(idx[None], (R, N))
        ok_r = jnp.concatenate([ok[None], jnp.zeros((R - 1, N), bool)])
        return pts_r, idx_r, ok_r

    pts_w, idx, ok = jax.lax.cond(
        loop_state.vocab_ready, bow_path, global_path, None
    )
    # Solve every candidate in parallel; the most-inlier verified one wins.
    good_r, pose_r, ninl_r = jax.vmap(
        lambda p, i, o, k: _reloc_solve(cfg, p, feats, i, o, k)
    )(pts_w, idx, ok, jax.random.split(key, R))
    best = jnp.argmax(jnp.where(good_r, ninl_r, -1))
    good = good_r[best]
    pose = pose_r[best]
    n_inl = ninl_r[best]
    # Re-center the reference keyframe on the recovered pose: local-scope
    # tracking (cfg.tracker.track_scope) builds its map around last_kf, so
    # leaving it at the pre-loss keyframe would immediately lose again.
    cam_w = se3.pose_inv(pose)[4:]
    kf_w = jax.vmap(se3.pose_inv)(map_state.kf_pose)[:, 4:]
    d2 = jnp.sum((kf_w - cam_w[None, :]) ** 2, axis=-1)
    nearest = jnp.argmin(
        jnp.where(map_state.kf_valid, d2, jnp.inf)
    ).astype(jnp.int32)
    new_track = track._replace(
        pose_cw=jnp.where(good, pose, track.pose_cw),
        velocity=se3.pose_identity(),
        status=jnp.where(good, ST_OK, ST_LOST).astype(jnp.int32),
        last_kf=jnp.where(good, nearest, track.last_kf),
        frame_idx=track.frame_idx + 1,
    )
    return new_track, good, n_inl
