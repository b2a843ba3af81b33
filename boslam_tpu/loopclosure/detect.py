"""Loop detection: BoW candidate retrieval, temporal consistency, geometric
verification (reference loop_closing.py, SURVEY.md §2.1/§3.4).

Candidate scoring is a dense BoW matmul over all keyframes with masks for
covisible neighbors and recency; the covisibility-neighborhood minimum score
is the adaptive baseline, exactly the reference's policy.  Verification is
descriptor matching + 3D-3D SE3 RANSAC on keypoint backprojections (RGBD =>
scale-1 SE3, reference compute_se3()).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import camera as cam_mod
from boslam_tpu.geometry import se3
from boslam_tpu.loopclosure.vocab import LoopState
from boslam_tpu.matching import hamming
from boslam_tpu.matching.rotation import rotation_consistency
from boslam_tpu.solvers import optimize_pose, ransac_se3


class LoopDetection(NamedTuple):
    candidate: jnp.ndarray  # scalar i32 keyframe id (-1 = none)
    score: jnp.ndarray      # scalar f32 BoW similarity
    consistent: jnp.ndarray # scalar bool (passed temporal consistency)


@functools.partial(jax.jit, static_argnums=(0,))
def detect_loop(cfg: SlamConfig, loop: LoopState, map_state, kf_id):
    """Score keyframes against ``kf_id``; returns (LoopState, LoopDetection)."""
    lc = cfg.loop
    K = loop.kf_bow.shape[0]
    scores = loop.kf_bow @ loop.kf_bow[kf_id]           # [K]
    covis_row = map_state.covis[kf_id]
    neighbors = (covis_row >= cfg.map.covis_min_weight) & map_state.kf_valid
    # Baseline: worst similarity among covisible neighbors (reference policy).
    min_score = jnp.min(jnp.where(neighbors, scores, jnp.inf))
    min_score = jnp.where(jnp.isfinite(min_score), min_score, 0.1)
    cand_mask = (
        map_state.kf_valid
        # Insertion-order gap, not slot-id gap: slots are free-list reused.
        & (map_state.kf_seq <= map_state.kf_seq[kf_id] - lc.min_gap_kf)
        & ~neighbors
        & (jnp.arange(K) != kf_id)
        & loop.vocab_ready
        & (scores >= jnp.maximum(min_score, 0.02))
    )
    # Top-C candidates with PARALLEL consistency streaks (reference
    # mvConsistentGroups): a genuine revisit must keep building its streak
    # even when an aliased-texture candidate outscores it on individual
    # keyframes, so the single-argmax streak is not enough.
    C = loop.streak_kf.shape[0]
    svals, sidx = jax.lax.top_k(jnp.where(cand_mask, scores, -1.0), C)
    found_c = jnp.take(cand_mask, sidx)                  # [C]

    # Group of candidate c = its covisibility neighborhood (+ itself); the
    # streak continues if it overlaps ANY previous streak's group.  Covis
    # groups, not slot adjacency: slots are free-list reused.
    eye_c = jax.nn.one_hot(sidx, K, dtype=bool)
    g_cand = ((map_state.covis[sidx] > 0) | eye_c) & map_state.kf_valid
    prev = jnp.clip(loop.streak_kf, 0, K - 1)            # [C]
    eye_p = jax.nn.one_hot(prev, K, dtype=bool)
    g_prev = (
        ((map_state.covis[prev] > 0) | eye_p)
        & map_state.kf_valid
        & (loop.streak_kf >= 0)[:, None]
    )
    overlap = jnp.any(g_cand[:, None, :] & g_prev[None, :, :], -1)  # [C, C]
    prev_len = jnp.max(
        jnp.where(overlap, loop.streak_len[None, :], 0), axis=1
    )                                                    # [C]
    streak = jnp.where(found_c, prev_len + 1, 0)
    new_loop = loop._replace(
        streak_kf=jnp.where(found_c, sidx, -1).astype(jnp.int32),
        streak_len=streak.astype(jnp.int32),
    )

    consistent_c = found_c & (streak >= lc.consistency)
    # Report the best consistent candidate if any, else the best candidate
    # (host logs it; verification keys off `consistent`).
    pick = jnp.argmax(jnp.where(consistent_c, svals, -1.0))
    any_cons = consistent_c[pick]
    best = jnp.where(any_cons, sidx[pick], sidx[0])
    found = jnp.where(any_cons, True, found_c[0])
    det = LoopDetection(
        candidate=jnp.where(found, best, -1).astype(jnp.int32),
        score=scores[jnp.clip(best, 0, K - 1)],
        consistent=any_cons,
    )
    return new_loop, det


@functools.partial(jax.jit, static_argnums=(0,))
def verify_loops_batch(cfg: SlamConfig, map_state, kf_curs, kf_cands, keys):
    """Verify a PADDED batch of loop candidates in one dispatch.

    The host accumulates every consistent candidate of a drained chunk and
    verifies them together: one dispatch and one readback per drain
    instead of a device round trip per candidate, at one consistent (often
    aliased) candidate per keyframe event.

    Returns vmapped (ok, T_cur_cand, n_inliers, idx, inlier_mask).
    """
    return jax.vmap(
        lambda a, b, k: verify_loop(cfg, map_state, a, b, k)
    )(kf_curs, kf_cands, keys)


# Covisible neighbors pooled into loop verification (static fan-in).
VERIFY_GROUP = 4


@functools.partial(jax.jit, static_argnums=(0,))
def verify_loop(cfg: SlamConfig, map_state, kf_cur, kf_cand, key):
    """Geometric verification against the candidate's COVISIBILITY GROUP
    (reference §3.4: the candidate's group map points are matched against
    the current keyframe, not just its own descriptors — VERDICT r4 item
    6): the current keyframe's descriptors match the stacked descriptors
    of the candidate + its top covisible neighbors, every group keypoint
    is backprojected into the CANDIDATE's camera frame through the current
    relative poses (locally accurate; drift is global), and SE3 RANSAC +
    pixel-GN refinement run on the pooled correspondences.  Genuine
    revisits under viewpoint change gain the neighbors' coverage, raising
    inlier counts at the source instead of via looser gates.

    Returns (ok, T_cur_cand [7], n_inliers, idx, inlier_mask); idx /
    inlier_mask are CANDIDATE-local keypoint matches (neighbor-sourced
    correspondences strengthen the geometry but are not fused — point
    fusion's write-back targets the candidate row).
    """
    lc = cfg.loop
    cam = cfg.camera
    K = map_state.kf_valid.shape[0]
    d_cur = map_state.kf_desc[kf_cur]
    z_cur = map_state.kf_depth[kf_cur]
    v_cur = map_state.kf_kp_valid[kf_cur] & (z_cur > 0)
    N = d_cur.shape[0]

    # Group: candidate first (match indices stay candidate-local in the
    # first block), then its strongest covisible neighbors.
    from boslam_tpu.mapping.map_state import covis_neighbors

    nbr_ids, _, nbr_ok = covis_neighbors(
        map_state, kf_cand, VERIFY_GROUP, cfg.map.covis_min_weight
    )
    nbr_ok = (
        nbr_ok & map_state.kf_valid[nbr_ids]
        & (nbr_ids != kf_cur) & (nbr_ids != kf_cand)
    )
    grp = jnp.concatenate([kf_cand[None], nbr_ids])            # [G+1]
    grp_ok = jnp.concatenate([jnp.ones((1,), bool), nbr_ok])
    gi = jnp.clip(grp, 0, K - 1)

    d_grp = map_state.kf_desc[gi].reshape(-1, 8)               # [(G+1)N, 8]
    z_grp = map_state.kf_depth[gi]                             # [G+1, N]
    v_grp = (
        map_state.kf_kp_valid[gi] & (z_grp > 0) & grp_ok[:, None]
    ).reshape(-1)
    # Each group member's camera-frame points -> the CANDIDATE's frame.
    T_cand_g = se3.pose_compose(
        map_state.kf_pose[kf_cand][None, :],
        se3.pose_inv(map_state.kf_pose[gi]),
    )                                                          # [G+1, 7]
    x_g = cam_mod.backproject(
        cam, map_state.kf_uv[gi].reshape(-1, 2), z_grp.reshape(-1)
    ).reshape(VERIFY_GROUP + 1, N, 3)
    xc_grp = se3.pose_apply(T_cand_g[:, None, :], x_g).reshape(-1, 3)
    # Note: using BA-refined MAP-POINT positions here instead of the raw
    # per-keyframe depth was measured WORSE (edge T_rel errors 38-126 mm
    # vs 42-87 mm, hall ATE 0.214 vs 0.129): world-frame point positions
    # absorb refinements from later (differently-drifted) keyframes, so
    # they are not consistent with the candidate's local frame, while the
    # raw group depth is locally consistent by construction.

    # Wide threshold: RANSAC gates the outliers, and grid-distributed
    # keypoints make cross-visit matches sparser than clustered ones.
    dist = hamming.hamming_matrix_mxu(d_cur, d_grp)
    idx, ok, _ = hamming.match_top2(
        dist, v_cur, v_grp, max_dist=cfg.matcher.hamming_high,
        ratio=0.9, mutual=True,
    )
    # Rotation-consistency histogram (reference Matcher) on CANDIDATE-block
    # matches: one global in-plane offset exists only between the two
    # frames; neighbor-sourced matches (different relative roll each) are
    # gated by mutual+threshold+RANSAC+GN instead.
    is_cand = (idx >= 0) & (idx < N)
    ang_grp = map_state.kf_angle[gi].reshape(-1)
    ok_rot = rotation_consistency(
        map_state.kf_angle[kf_cur],
        ang_grp[jnp.clip(idx, 0, ang_grp.shape[0] - 1)],
        ok & is_cand,
    )
    ok = jnp.where(is_cand, ok_rot, ok)
    idx = jnp.where(ok, idx, -1)
    j = jnp.clip(idx, 0, (VERIFY_GROUP + 1) * N - 1)
    xc_cur = cam_mod.backproject(cam, map_state.kf_uv[kf_cur], z_cur)
    xc_cand = xc_grp
    # Depth-adaptive inlier radius (per correspondence): RGBD 3D noise
    # grows with range, and a fixed radius starves RANSAC of far points in
    # hall-scale scenes (r4 finding: genuine revisits with 60-80 refined
    # pixel-GN inliers rejected because <40 far-depth correspondences fit
    # inside 10 cm).
    thr = jnp.maximum(lc.se3_threshold, lc.se3_rel_threshold * z_cur)
    inl_gate = max(lc.se3_inliers,
                   int(round(lc.se3_inlier_frac * cfg.orb.n_features)))
    res = ransac_se3(
        xc_cand[j], xc_cur, ok, key,
        n_hypotheses=cfg.tracker.ransac_iters,
        threshold=thr,
        min_inliers=inl_gate,
    )
    # Refine the RANSAC SE3 at pixel accuracy: robust GN on reprojection (+
    # depth) residuals of the matches (reference: SE3 solver then projection
    # optimization, §3.4).  The Umeyama fit is only ~cm-accurate at the 3D
    # inlier radius; feeding that straight into the pose graph injects the
    # error into every keyframe.  Gate on the GN chi2 inlier count — a much
    # tighter verification than the 3D radius.
    refined = optimize_pose(
        cfg, res.pose, xc_cand[j], map_state.kf_uv[kf_cur], z_cur,
        ok & (z_cur > 0), ok, map_state.kf_octave[kf_cur],
        inliers0=res.inliers,
    )
    # Gates.  The POOLED inliers measure geometric evidence, but the
    # decision must still require DIRECT cur<->candidate overlap — without
    # the direct gate, a candidate whose group merely covers shared scenery
    # verifies "loops" between views that never co-observed anything, and
    # the resulting early edges warp the trajectory (measured r5: orbit
    # fixture ATE 0.029 -> 0.21 with pooled-only gating).
    is_cand = (idx >= 0) & (idx < N)
    cand_inl = jnp.sum(refined.inliers & ok & is_cand)
    enough_matches = jnp.sum(ok & is_cand) >= lc.min_score_matches
    good = (
        res.ok
        & enough_matches
        & (refined.n_inliers >= inl_gate)       # pooled geometric evidence
        & (cand_inl * 2 >= inl_gate)            # direct-overlap requirement
    )
    # Fusion consumes CANDIDATE-local matches (see docstring): neighbor-
    # sourced correspondences verified the geometry but are dropped here.
    idx_cand = jnp.where(is_cand, idx, -1)
    return (
        good, refined.pose, refined.n_inliers, idx_cand,
        refined.inliers & ok & (idx_cand >= 0),
    )
