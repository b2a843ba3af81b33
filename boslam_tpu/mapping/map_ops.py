"""Pure map-update operations: keyframe insertion, point creation, culling,
observation fusion, statistics.

Covers the reference's keyframe machinery (SURVEY.md §2.1 "Map /
CovisibilityGraph" + §3.3 LocalMapManager steps: insert, cull recent points,
create RGBD points from keypoint depth, fuse duplicates, cull redundant
keyframes) as masked free-list updates on the MapState pytree — no object
graphs, no locks, recompilation-free static shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import camera as cam_mod
from boslam_tpu.geometry import se3
from boslam_tpu.mapping.map_state import (
    MapState, free_kf_slot, incidence, latest_kf_slot, point_obs_count,
    recompute_covis,
)
from boslam_tpu.matching import hamming
from boslam_tpu.utils import scatter


def _spanning_parent(state: MapState, slot) -> jnp.ndarray:
    """Parent = most covisible OLDER keyframe (ORB-SLAM spanning tree).

    "Older" means inserted earlier (kf_seq), not a lower slot id — culled
    slots are reused, so slot order is not insertion order.
    """
    row = state.covis[slot] * state.kf_valid
    older = (state.kf_seq >= 0) & (state.kf_seq < state.kf_seq[slot])
    row = jnp.where(older, row, -1)
    parent = jnp.argmax(row)
    return jnp.where(
        (state.kf_seq[slot] > 0) & (row[parent] > 0), parent, -1
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(0,))
def insert_keyframe(
    cfg: SlamConfig, state: MapState, feats, pose_cw, match_pt, match_ok, frame_idx
) -> MapState:
    """Insert the current frame as a keyframe.

    Args:
      feats: FrameFeatures.
      pose_cw: [7] tracked pose.
      match_pt: [N] i32 map-point id matched per keypoint (-1 = none).
      match_ok: [N] bool tracking-inlier mask for those matches.

    New map points are created directly from keypoint depth (RGBD privilege:
    no triangulation, reference §3.2 init_from_rgbd / §3.3 create new
    MapPoints), allocated from the free list; when the pool is full the
    creation is dropped (overflow policy, SURVEY.md §7.2).

    Returns (state, slot): keyframe slots are free-list allocated (culled
    slots are reused — a long sequence can insert unboundedly many keyframes
    as long as culling keeps the live count under max_keyframes).  The caller
    must gate insertion on a free slot existing (``~all(kf_valid)``).
    """
    N = feats.uv.shape[0]
    P = cfg.map.max_points
    slot, _ = free_kf_slot(state)

    obs = jnp.where(match_ok & feats.valid & (match_pt >= 0), match_pt, -1)

    # ---- allocate new points for unmatched depth-backed keypoints -------
    create = feats.valid & feats.has_depth & (obs < 0)
    free_idx, = jnp.nonzero(~state.pt_valid, size=N, fill_value=P)
    rank = jnp.cumsum(create) - 1
    new_id = free_idx[jnp.clip(rank, 0, N - 1)]
    ok_create = create & (new_id < P)
    new_id = jnp.where(ok_create, new_id, P)  # P = drop sentinel

    t_wc = se3.pose_inv(pose_cw)
    cam_w = t_wc[4:7]
    xyz_w = se3.pose_apply(t_wc[None], feats.xyz)
    # Viewing model (reference MapPoint normal + view-distance band): unit
    # direction point -> camera, and the scale band predicted from the
    # creating keypoint's octave (seen at distance d at pyramid level o
    # => recognizable between d*s^o / s^(L-1) and d*s^o).
    dvec = cam_w[None, :] - xyz_w
    dist = jnp.linalg.norm(dvec, axis=-1)
    vdir = dvec / jnp.maximum(dist, 1e-9)[:, None]
    sf = cfg.orb.scale_factor
    dmax = dist * sf ** feats.octave.astype(jnp.float32)
    dmin = dmax / sf ** (cfg.orb.n_levels - 1)
    st = state._replace(
        pt_xyz=state.pt_xyz.at[new_id].set(xyz_w, mode="drop"),
        pt_desc=state.pt_desc.at[new_id].set(feats.desc, mode="drop"),
        pt_angle=state.pt_angle.at[new_id].set(feats.angle, mode="drop"),
        pt_valid=state.pt_valid.at[new_id].set(True, mode="drop"),
        pt_ref_kf=state.pt_ref_kf.at[new_id].set(slot, mode="drop"),
        pt_first_kf=state.pt_first_kf.at[new_id].set(state.n_kf, mode="drop"),
        pt_n_vis=state.pt_n_vis.at[new_id].set(1, mode="drop"),
        pt_n_found=state.pt_n_found.at[new_id].set(1, mode="drop"),
        pt_dir_sum=state.pt_dir_sum.at[new_id].set(vdir, mode="drop"),
        pt_dmin=state.pt_dmin.at[new_id].set(dmin, mode="drop"),
        pt_dmax=state.pt_dmax.at[new_id].set(dmax, mode="drop"),
    )
    # Re-observed points accumulate this keyframe's viewing direction into
    # their mean-direction sum (reference UpdateNormalAndDepth on
    # AddObservation); exact window-wide refresh happens at fuse time
    # (refresh_point_model).
    reobs = jnp.where(match_ok & feats.valid & (obs >= 0), obs, P)
    dvec_o = cam_w[None, :] - st.pt_xyz[jnp.clip(reobs, 0, P - 1)]
    vdir_o = dvec_o / jnp.maximum(
        jnp.linalg.norm(dvec_o, axis=-1), 1e-9
    )[:, None]
    st = st._replace(
        pt_dir_sum=st.pt_dir_sum.at[reobs].add(vdir_o, mode="drop")
    )

    obs = jnp.where(ok_create, new_id, obs).astype(jnp.int32)

    # ---- write the keyframe row ----------------------------------------
    st = st._replace(
        kf_pose=st.kf_pose.at[slot].set(pose_cw),
        kf_valid=st.kf_valid.at[slot].set(True),
        kf_uv=st.kf_uv.at[slot].set(feats.uv),
        kf_depth=st.kf_depth.at[slot].set(feats.depth),
        kf_desc=st.kf_desc.at[slot].set(feats.desc),
        kf_octave=st.kf_octave.at[slot].set(feats.octave),
        kf_angle=st.kf_angle.at[slot].set(feats.angle),
        kf_kp_valid=st.kf_kp_valid.at[slot].set(feats.valid),
        kf_obs_pt=st.kf_obs_pt.at[slot].set(obs),
        kf_frame_idx=st.kf_frame_idx.at[slot].set(frame_idx),
        kf_seq=st.kf_seq.at[slot].set(st.n_kf),
        n_kf=st.n_kf + 1,
    )
    st = recompute_covis(st)
    st = st._replace(
        spanning_parent=st.spanning_parent.at[slot].set(_spanning_parent(st, slot))
    )
    return st, slot


@functools.partial(jax.jit, static_argnums=(0,))
def update_track_stats(cfg: SlamConfig, state: MapState, visible, match_pt, match_ok):
    """After tracking a frame: bump per-point visible/found counters
    (reference MapPoint found-ratio bookkeeping, §3.2)."""
    P = cfg.map.max_points
    n_vis = state.pt_n_vis + visible.astype(jnp.int32)
    tgt = jnp.where(match_ok & (match_pt >= 0), match_pt, P)
    n_found = state.pt_n_found.at[tgt].add(1, mode="drop")
    return state._replace(pt_n_vis=n_vis, pt_n_found=n_found)


def _drop_dead_obs(state: MapState) -> MapState:
    """Clear observation entries that point at dead points."""
    obs = state.kf_obs_pt
    alive = jnp.where(
        obs >= 0,
        state.pt_valid[jnp.clip(obs, 0, state.pt_valid.shape[0] - 1)],
        False,
    )
    return state._replace(kf_obs_pt=jnp.where(alive, obs, -1))


@functools.partial(jax.jit, static_argnums=(0, 2))
def cull_points(cfg: SlamConfig, state: MapState, update_covis: bool = True) -> MapState:
    """Remove unreliable recent points (reference local_mapping culling:
    found-ratio < 0.25, or seen by < 3 keyframes once mature).

    ``update_covis=False`` lets a fused keyframe pipeline defer the covis
    refresh to its final op (the incidence scatter is the expensive part).
    """
    m = cfg.map
    n_obs = point_obs_count(state)
    age = state.n_kf - state.pt_first_kf  # in keyframes
    found_ratio = state.pt_n_found / jnp.maximum(state.pt_n_vis, 1)
    bad_ratio = (found_ratio < m.cull_min_found_ratio) & (state.pt_n_vis >= 4)
    bad_obs = (n_obs < m.cull_min_obs) & (age >= 3)
    keep = state.pt_valid & ~bad_ratio & ~bad_obs
    st = state._replace(pt_valid=keep)
    st = _drop_dead_obs(st)
    return recompute_covis(st) if update_covis else st


@functools.partial(jax.jit, static_argnums=(0,))
def cull_one_keyframe(cfg: SlamConfig, state: MapState):
    """Cull the single most redundant keyframe, if any qualifies
    (reference: >= 90% of its points seen in >= 3 other keyframes).

    Root (0) and the latest keyframe are protected.  One-at-a-time matches
    the reference's incremental schedule and avoids cascade removals.

    Returns (MapState, cull_info [11] f32): the victim's identity and its
    pose RELATIVE to its spanning parent — [victim_slot, victim_seq,
    parent_slot, parent_seq, T_victim_parent(7)], victim_slot = -1 when
    nothing was culled.  The host records this chain (reference: erased
    keyframes keep Tcp to their parent) so frames whose reference keyframe
    was culled still re-anchor to a LIVE corrected keyframe at trajectory
    dump time instead of falling back to their raw drifted pose.
    """
    K, N = state.kf_obs_pt.shape
    n_obs = point_obs_count(state)  # [P]
    obs = state.kf_obs_pt
    has = obs >= 0
    obs_cnt = jnp.where(
        has, n_obs[jnp.clip(obs, 0, n_obs.shape[0] - 1)], 0
    )  # [K, N]
    redundant = jnp.sum((obs_cnt >= 4) & has, axis=1)
    total = jnp.maximum(jnp.sum(has, axis=1), 1)
    frac = redundant / total
    eligible = (
        state.kf_valid
        & (state.kf_seq > 0)                      # root (seq 0) protected
        & (jnp.arange(K) != latest_kf_slot(state))
        & (frac >= cfg.map.kf_cull_redundancy)
        & (jnp.sum(has, axis=1) > 0)
    )
    victim = jnp.argmax(jnp.where(eligible, frac, -1.0))
    do = eligible[victim]
    return _remove_keyframe(state, victim, do)


@functools.partial(jax.jit, static_argnums=(0,))
def evict_for_slot(cfg: SlamConfig, state: MapState):
    """Capacity-saturation eviction (SURVEY.md §7.2 overflow policy).

    When every keyframe slot is occupied and nothing meets the redundancy
    threshold, ``can_kf`` used to silently refuse insertion forever and
    tracking quality decayed with no signal (VERDICT r4 item 4).  Instead,
    when the pool is FULL this evicts the lowest-VALUE keyframe — minimal
    summed covisibility weight to the live window (the latest keyframe and
    its covisible group), ties broken toward the oldest — so the map keeps
    absorbing new viewpoints at bounded capacity.  Root (gauge anchor) and
    the live window itself are protected.  No-op (victim slot -1) while a
    free slot exists.  Same (state, cull_info[11]) contract as
    ``cull_one_keyframe`` so the host cull-chain / trajectory re-anchoring
    machinery applies unchanged.
    """
    K = state.kf_valid.shape[0]
    latest = latest_kf_slot(state)
    # Live window: latest + its strongest covisible neighbors.
    w_row = state.covis[latest] * state.kf_valid
    window = w_row >= jnp.maximum(cfg.map.covis_min_weight, 1)
    window = window.at[latest].set(True)
    # Value = how much a keyframe still shares with the live window.
    value = jnp.sum(
        jnp.where(window[None, :], state.covis, 0), axis=1
    ).astype(jnp.float32)
    eligible = (
        state.kf_valid
        & (state.kf_seq > 0)          # root (gauge anchor) protected
        & ~window                      # never evict the live window
        & (jnp.arange(K) != latest)
    )
    # Small-pool fallback: if the whole pool IS the live window (tight
    # loops at tiny max_keyframes), relax the window protection — only
    # root and the latest stay untouchable, so insertion never deadlocks.
    fallback = (
        state.kf_valid & (state.kf_seq > 0) & (jnp.arange(K) != latest)
    )
    use = jnp.where(jnp.any(eligible), eligible, fallback)
    # Lexicographic (value, seq): evict the most isolated, oldest first.
    score = value * 1e6 + state.kf_seq.astype(jnp.float32)
    victim = jnp.argmin(jnp.where(use, score, jnp.inf))
    do = jnp.all(state.kf_valid) & use[victim]
    return _remove_keyframe(state, victim, do)


def _remove_keyframe(state: MapState, victim, do):
    """Shared removal machinery for cull_one_keyframe / evict_for_slot:
    re-home points and spanning-tree children, invalidate touching loop
    edges, free the slot, and emit the [11] cull-chain record."""
    K = state.kf_valid.shape[0]
    # Re-home points referencing the victim to its spanning parent (root as
    # fallback): pt_ref_kf must always name a LIVE keyframe, or pose-graph
    # corrections would leave those points behind (stale-map tracking loss).
    parent = state.spanning_parent[victim]
    parent = jnp.where(
        (parent >= 0) & state.kf_valid[jnp.clip(parent, 0, K - 1)], parent, 0
    ).astype(jnp.int32)
    new_ref = jnp.where(
        do & (state.pt_ref_kf == victim), parent, state.pt_ref_kf
    )
    # Re-home CHILDREN of the victim in the spanning tree to the victim's own
    # parent, and clear the victim's parent entry.  Without this, once the
    # victim's slot is free-list reused, build_essential_edges would
    # re-validate the stale child->victim spanning edge against an unrelated
    # new keyframe (stale-slot corruption of every later pose-graph solve).
    new_sp = jnp.where(
        do & (state.spanning_parent == victim), parent, state.spanning_parent
    )
    new_sp = new_sp.at[victim].set(jnp.where(do, -1, new_sp[victim]))
    # Invalidate loop edges touching the victim for the same reason: their
    # STORED measurement (loop_rel) would rigidly constrain whatever new
    # keyframe reuses the slot.  Endpoint -1 marks the edge dead;
    # build_essential_edges gates lp_valid on endpoints >= 0.
    touches = do & (
        (state.loop_edges[:, 0] == victim) | (state.loop_edges[:, 1] == victim)
    )
    new_loop_edges = jnp.where(touches[:, None], -1, state.loop_edges)
    st = state._replace(
        kf_valid=state.kf_valid.at[victim].set(
            jnp.where(do, False, state.kf_valid[victim])
        ),
        kf_obs_pt=jnp.where(
            do & (jnp.arange(K) == victim)[:, None], -1, state.kf_obs_pt
        ),
        pt_ref_kf=new_ref,
        spanning_parent=new_sp,
        loop_edges=new_loop_edges,
    )
    t_vp = se3.pose_compose(
        state.kf_pose[victim], se3.pose_inv(state.kf_pose[parent])
    )
    f32 = jnp.float32
    cull_info = jnp.concatenate([
        jnp.stack([
            jnp.where(do, victim, -1).astype(f32),
            state.kf_seq[victim].astype(f32),
            parent.astype(f32),
            state.kf_seq[parent].astype(f32),
        ]),
        t_vp,
    ])
    return recompute_covis(st), cull_info


@functools.partial(jax.jit, static_argnums=(0, 3))
def fuse_new_keyframe(
    cfg: SlamConfig, state: MapState, slot, n_neighbors: int = 4
) -> MapState:
    """Fuse keyframe ``slot``'s points into its covisible neighbors.

    Reference local_mapping "fuse duplicates into covisible neighbor KFs"
    (§3.3): for each top-covisibility neighbor, project the new keyframe's
    points, Hamming-match them against the neighbor's keypoints in a window;
    an unassociated matched keypoint gains an observation of the point, and a
    keypoint already bound to a different point triggers a merge that keeps
    the better-observed point (global id remap).
    """
    K, N = state.kf_obs_pt.shape
    P = cfg.map.max_points
    nbr_ids, nbr_w, nbr_ok = _top_neighbors(cfg, state, slot, n_neighbors)

    new_pts = state.kf_obs_pt[slot]  # [N] point ids of the new KF
    pts_ok = new_pts >= 0
    pid = jnp.clip(new_pts, 0, P - 1)
    xyz = state.pt_xyz[pid]
    desc = state.pt_desc[pid]
    n_obs = point_obs_count(state)

    def fuse_into(carry, nb):
        obs_tab, remap = carry
        nbr, ok_nb = nb
        pose = state.kf_pose[nbr]
        xc = se3.pose_apply(pose[None], xyz)
        uv = cam_mod.project(cfg.camera, xc)
        vis = (
            pts_ok
            & ok_nb
            & (xc[..., 2] > cfg.camera.depth_min)
            & cam_mod.in_image(cfg.camera, uv, 1.0)
        )
        # keypoints of the neighbor
        kuv = state.kf_uv[nbr]
        kval = state.kf_kp_valid[nbr]
        d2 = jnp.sum((kuv[:, None, :] - uv[None, :, :]) ** 2, -1)
        r = cfg.matcher.search_radius * (
            cfg.orb.scale_factor ** state.kf_octave[nbr].astype(jnp.float32)
        )
        window = (d2 <= r[:, None] ** 2) & vis[None, :]
        dist = hamming.hamming_matrix_mxu(state.kf_desc[nbr], desc)
        idx, mok, _ = hamming.match_top2(
            dist, kval, vis, max_dist=cfg.matcher.hamming_low,
            ratio=1.0, mutual=True, extra_mask=window,
        )
        # idx[s] = new-KF keypoint index whose point matches neighbor slot s
        cand_pt = jnp.where(mok, new_pts[jnp.clip(idx, 0, N - 1)], -1)
        existing = obs_tab[nbr]
        # Case 1: neighbor slot unassociated -> add observation.
        add = mok & (existing < 0) & (cand_pt >= 0)
        new_row = jnp.where(add, cand_pt, existing)
        obs_tab = obs_tab.at[nbr].set(jnp.where(ok_nb, new_row, existing))
        # Case 2: duplicate -> redirect the lesser-observed point.
        dup = mok & (existing >= 0) & (cand_pt >= 0) & (existing != cand_pt)
        keep_exist = n_obs[jnp.clip(existing, 0, P - 1)] >= n_obs[jnp.clip(cand_pt, 0, P - 1)]
        src = jnp.where(keep_exist, cand_pt, existing)
        dst = jnp.where(keep_exist, existing, cand_pt)
        src = jnp.where(dup & ok_nb, src, P + 1)  # P + 1: dropped
        remap = scatter.set_last(remap, src, dst)
        return (obs_tab, remap), None

    remap0 = jnp.concatenate([jnp.arange(P, dtype=jnp.int32), jnp.array([-1], jnp.int32)])
    (obs_tab, remap), _ = jax.lax.scan(
        fuse_into, (state.kf_obs_pt, remap0), (nbr_ids, nbr_ok)
    )
    # Resolve two-step merge chains (A->B, B->C), then apply globally.
    remap = remap.at[:P].set(remap[jnp.clip(remap[:P], 0, P)])
    merged_away = remap[:P] != jnp.arange(P)
    obs_tab = jnp.where(obs_tab >= 0, remap[jnp.clip(obs_tab, 0, P)], -1)
    st = state._replace(
        kf_obs_pt=obs_tab,
        pt_valid=state.pt_valid & ~merged_away,
    )
    return recompute_covis(st)


def _top_neighbors(cfg: SlamConfig, state: MapState, kf_id, k: int):
    row = state.covis[kf_id] * state.kf_valid
    row = row.at[kf_id].set(0)
    w, ids = jax.lax.top_k(row, k)
    return ids, w, w >= cfg.map.covis_min_weight


@functools.partial(jax.jit, static_argnums=(0, 3))
def refresh_point_model(
    cfg: SlamConfig, state: MapState, slot, n_neighbors: int = 8
) -> MapState:
    """Refresh the viewing model of every point observed in keyframe
    ``slot``'s covisibility window (reference MapPoint
    ComputeDistinctiveDescriptors + UpdateNormalAndDepth, SURVEY.md §2.1
    Map row: representative descriptor = min mean Hamming to the point's
    observations; normal = mean viewing direction; min/max view distance
    from the observing octave).

    Dense form: instead of per-point observation lists, flatten the window's
    [W, N] observation table, compute ONE [M, M] Hamming matrix over
    all window descriptors, mask it by same-point, and pick each point's
    medoid with segment reductions — no gather chasing, fixed shapes.
    """
    K, N = state.kf_obs_pt.shape
    P = cfg.map.max_points
    nbr_ids, _, nbr_ok = _top_neighbors(cfg, state, slot, n_neighbors)
    win = jnp.concatenate([slot[None], nbr_ids])              # [W]
    win_ok = jnp.concatenate([jnp.ones(1, bool), nbr_ok]) & state.kf_valid[win]
    obs = state.kf_obs_pt[win]                                # [W, N]
    valid = win_ok[:, None] & (obs >= 0) & state.kf_kp_valid[win]
    pid = jnp.where(valid, obs, P).reshape(-1)                # [M], P = dump
    desc = state.kf_desc[win].reshape(-1, 8)
    M = pid.shape[0]

    # Representative descriptor: medoid by mean Hamming among observations.
    D = hamming.hamming_matrix_mxu(desc, desc).astype(jnp.float32)
    same = (pid[:, None] == pid[None, :]) & (pid < P)[None, :]
    cnt = jnp.sum(same, axis=1)
    mean_d = jnp.sum(jnp.where(same, D, 0.0), axis=1) / jnp.maximum(cnt, 1)
    score = jnp.where(pid < P, mean_d, jnp.inf)
    best = jax.ops.segment_min(score, pid, num_segments=P + 1)[:P]
    is_best = score <= best[jnp.clip(pid, 0, P - 1)] + 1e-3
    rank = jnp.where(is_best & (pid < P), jnp.arange(M), M)
    winner = jax.ops.segment_min(rank, pid, num_segments=P + 1)[:P]
    has = winner < M
    widx = jnp.clip(winner, 0, M - 1)
    new_desc = jnp.where(has[:, None], desc[widx], state.pt_desc)
    angles = state.kf_angle[win].reshape(-1)
    new_angle = jnp.where(has, angles[widx], state.pt_angle)

    # Normal: exact mean view direction over the window's observations
    # (replaces the incremental insert-time sum for these points — also
    # repairs staleness after loop corrections moved cameras/points).
    cam_w = jax.vmap(se3.pose_inv)(state.kf_pose[win])[:, 4:7]  # [W, 3]
    dvec = cam_w[:, None, :] - state.pt_xyz[jnp.clip(obs, 0, P - 1)]
    dist = jnp.linalg.norm(dvec, axis=-1)                     # [W, N]
    vdir = dvec / jnp.maximum(dist, 1e-9)[..., None]
    dir_sum = scatter.segment_sum(
        (vdir * valid[..., None]).reshape(-1, 3), pid, num_segments=P + 1
    )[:P]
    new_dir = jnp.where(has[:, None], dir_sum, state.pt_dir_sum)

    # Distance band re-predicted from the medoid observation's octave.
    sf = cfg.orb.scale_factor
    oct_flat = state.kf_octave[win].reshape(-1)
    dmax_w = dist.reshape(-1)[widx] * sf ** oct_flat[widx].astype(jnp.float32)
    dmin_w = dmax_w / sf ** (cfg.orb.n_levels - 1)
    return state._replace(
        pt_desc=new_desc,
        pt_angle=new_angle,
        pt_dir_sum=new_dir,
        pt_dmin=jnp.where(has, dmin_w, state.pt_dmin),
        pt_dmax=jnp.where(has, dmax_w, state.pt_dmax),
    )
