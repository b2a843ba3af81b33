"""Pose-graph optimization over the essential graph (SURVEY.md §2.1
"Optimization wrappers (c)", §3.4 optimize_pose_graph).

Replaces g2o's SE3 pose graph: vertices are all keyframe poses, edges are the
spanning tree + high-weight covisibility pairs + loop edges, residual
``r = log(T_meas^-1 · T_i · T_j^-1)``.  Per-edge 6x12 Jacobians come from
``jax.jacfwd`` vmapped over the static edge list; the normal equations are
assembled dense ([K*6, K*6] — at K=256 a 1536^2 Cholesky) with
gauge fixing by row masking.  Damped GN for ``pg_iters`` iterations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.mapping.map_state import MapState
from boslam_tpu.utils import scatter


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray       # [E] i32
    j: jnp.ndarray       # [E] i32
    t_meas: jnp.ndarray  # [E, 7] measured T_i · T_j^-1
    weight: jnp.ndarray  # [E] f32
    valid: jnp.ndarray   # [E] bool


def build_essential_edges(
    cfg: SlamConfig, state: MapState, max_covis_edges: int | None = None
) -> PoseGraphEdges:
    """Essential graph edges with measurements taken from current poses.

    Call BEFORE applying any loop correction so the relative measurements
    encode the pre-correction (locally consistent) geometry; append the loop
    edge afterwards with its measured SE3.
    """
    K = state.kf_pose.shape[0]
    E_cov = 4 * K if max_covis_edges is None else max_covis_edges

    # Spanning-tree edges.
    child = jnp.arange(K, dtype=jnp.int32)
    parent = state.spanning_parent
    sp_valid = (parent >= 0) & state.kf_valid & state.kf_valid[jnp.clip(parent, 0, K - 1)]
    sp_j = jnp.clip(parent, 0, K - 1)

    # Strong covisibility edges: top-E_cov upper-triangle weights.
    iu = jnp.triu_indices(K, k=1)
    w = state.covis[iu]
    w = w * state.kf_valid[iu[0]] * state.kf_valid[iu[1]]
    topw, top_idx = jax.lax.top_k(w, E_cov)
    cv_i = iu[0][top_idx].astype(jnp.int32)
    cv_j = iu[1][top_idx].astype(jnp.int32)
    cv_valid = topw >= cfg.map.covis_essential_weight

    # Loop edges.  Endpoints are -1 when the edge was invalidated by a
    # keyframe cull (map_ops.cull_one_keyframe); also require both endpoint
    # keyframes live so a stale measurement can never constrain a reused slot.
    nl = state.loop_edges.shape[0]
    lp_i = state.loop_edges[:, 0]
    lp_j = state.loop_edges[:, 1]
    lp_valid = (
        (jnp.arange(nl) < state.n_loop_edges)
        & (lp_i >= 0) & (lp_j >= 0)
        & state.kf_valid[jnp.clip(lp_i, 0, K - 1)]
        & state.kf_valid[jnp.clip(lp_j, 0, K - 1)]
    )

    ei = jnp.concatenate([child, cv_i, lp_i])
    ej = jnp.concatenate([sp_j, cv_j, lp_j])
    valid = jnp.concatenate([sp_valid, cv_valid, lp_valid])
    Ti = state.kf_pose[jnp.clip(ei, 0, K - 1)]
    Tj = state.kf_pose[jnp.clip(ej, 0, K - 1)]
    t_rel = se3.pose_compose(Ti, se3.pose_inv(Tj))
    # Loop edges carry their own measured relative pose.
    t_meas = jnp.concatenate(
        [t_rel[: K + E_cov], state.loop_rel]
    )
    weight = jnp.concatenate(
        [jnp.full(K, 100.0), topw.astype(jnp.float32),
         jnp.full(nl, 200.0)]
    )
    return PoseGraphEdges(ei, ej, t_meas, weight, valid)


def _edge_residual(t_meas, Ti, Tj):
    return se3.log(
        se3.pose_compose(se3.pose_inv(t_meas), se3.pose_compose(Ti, se3.pose_inv(Tj)))
    )


@functools.partial(jax.jit, static_argnums=(0,))
def optimize_pose_graph(
    cfg: SlamConfig, poses, kf_valid, edges: PoseGraphEdges, fixed_mask
):
    """Damped GN on the pose graph.  ``fixed_mask`` [K] bool freezes gauge
    vertices (KF0 + the loop keyframe, reference policy).

    Returns optimized poses [K, 7].
    """
    K = poses.shape[0]
    free = kf_valid & ~fixed_mask

    def residual_at(xi_i, xi_j, Ti, Tj, tm):
        return _edge_residual(tm, se3.retract(Ti, xi_i), se3.retract(Tj, xi_j))

    jac_fn = jax.vmap(
        jax.jacfwd(residual_at, argnums=(0, 1)), in_axes=(0, 0, 0, 0, 0)
    )

    def gn_iter(poses, _):
        Ti = poses[jnp.clip(edges.i, 0, K - 1)]
        Tj = poses[jnp.clip(edges.j, 0, K - 1)]
        r = jax.vmap(_edge_residual)(edges.t_meas, Ti, Tj)      # [E, 6]
        zeros = jnp.zeros((edges.i.shape[0], 6))
        Ji, Jj = jac_fn(zeros, zeros, Ti, Tj, edges.t_meas)     # [E, 6, 6] x2
        w = jnp.where(edges.valid, edges.weight, 0.0)

        # Assemble dense H and b from per-edge blocks with order-fixed
        # segment sums (keyed by vertex, and by vertex pair for H).
        Js = (Ji, Jj)
        ids = (jnp.where(edges.valid, edges.i, -1),
               jnp.where(edges.valid, edges.j, -1))
        b = scatter.segment_sum(
            jnp.concatenate(
                [-jnp.einsum("eri,e,er->ei", Ja, w, r) for Ja in Js]
            ),
            jnp.concatenate(ids), K,
        )
        Hb = jnp.concatenate([
            jnp.einsum("eri,e,erj->eij", Ja, w, Jb) for Ja in Js for Jb in Js
        ])
        pair = jnp.concatenate([
            jnp.where((ia >= 0) & (ib >= 0), ia * K + ib, -1)
            for ia in ids for ib in ids
        ])
        H = scatter.segment_sum(Hb, pair, K * K)
        H = H.reshape(K, K, 6, 6).transpose(0, 2, 1, 3)

        m = jnp.repeat(free.astype(jnp.float32), 6)
        Hf = H.reshape(K * 6, K * 6)
        Hf = Hf * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        bf = b.reshape(K * 6) * m
        Hf = Hf + 1e-6 * jnp.eye(K * 6) + 1e-3 * jnp.diag(jnp.diag(Hf))
        dx = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hf), bf)
        dx = dx.reshape(K, 6) * free[:, None]
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)  # skip bad solves
        return se3.retract(poses, dx), None

    poses, _ = jax.lax.scan(gn_iter, poses, None, length=cfg.loop.pg_iters)
    return poses


@functools.partial(jax.jit, static_argnums=(0,))
def apply_pose_correction(cfg: SlamConfig, state: MapState, new_poses):
    """Move every map point rigidly with its reference keyframe after a
    pose-graph update: X' = T_wc_new(ref) · T_cw_old(ref) · X (reference
    correct_loop map-point propagation, §3.4)."""
    K = state.kf_pose.shape[0]
    ref = jnp.clip(state.pt_ref_kf, 0, K - 1)
    T_old_cw = state.kf_pose[ref]
    T_new_wc = se3.pose_inv(new_poses[ref])
    corr = se3.pose_compose(T_new_wc, T_old_cw)
    xyz = se3.pose_apply(corr, state.pt_xyz)
    # Points must move with a LIVE keyframe; a dead ref (shouldn't happen —
    # culling re-homes refs) would get an identity correction and go stale.
    move = state.pt_valid & state.kf_valid[ref]
    xyz = jnp.where(move[:, None], xyz, state.pt_xyz)
    return state._replace(kf_pose=new_poses, pt_xyz=xyz)


def fuse_loop_points(cfg: SlamConfig, state: MapState, kf_cur, kf_cand,
                     match_idx, match_ok) -> MapState:
    """Fuse duplicated map points across a verified loop (reference
    correct_loop, §3.4): matched keypoint pairs (cur slot i, cand slot j)
    observing DIFFERENT points merge them (the loop side's point survives),
    and an unbound slot on either side gains the other side's observation.
    The resulting shared observations create the covisibility edge that
    stops the same loop from re-firing every subsequent keyframe.
    """
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    j = jnp.clip(match_idx, 0, N - 1)
    row_cur = state.kf_obs_pt[kf_cur]            # [N] point of cur slot i
    pt_cand = state.kf_obs_pt[kf_cand][j]        # [N] point of matched cand slot
    ok = match_ok & (match_idx >= 0)

    # Merge: cur's point -> cand's (older, loop-side) point.
    both = ok & (row_cur >= 0) & (pt_cand >= 0) & (row_cur != pt_cand)
    src = jnp.where(both, row_cur, P + 1)  # P + 1: dropped
    remap = jnp.concatenate(
        [jnp.arange(P, dtype=jnp.int32), jnp.array([-1], jnp.int32)]
    )
    remap = scatter.set_last(remap, src, pt_cand)
    remap = remap.at[:P].set(remap[jnp.clip(remap[:P], 0, P)])  # 2-step chains
    obs = jnp.where(
        state.kf_obs_pt >= 0, remap[jnp.clip(state.kf_obs_pt, 0, P)], -1
    )
    merged_away = remap[:P] != jnp.arange(P)

    # Bind unassociated slots to the other side's (post-remap) point.
    row_cur = obs[kf_cur]
    pt_cand_new = jnp.where(pt_cand >= 0, remap[jnp.clip(pt_cand, 0, P)], -1)
    bind_cur = ok & (row_cur < 0) & (pt_cand_new >= 0)
    obs = obs.at[kf_cur].set(jnp.where(bind_cur, pt_cand_new, row_cur))
    row_cand = obs[kf_cand]
    cur_pt_new = obs[kf_cur]
    give = ok & (row_cand[j] < 0) & (cur_pt_new >= 0)
    row_cand = scatter.set_last(row_cand, jnp.where(give, j, N), cur_pt_new)
    obs = obs.at[kf_cand].set(row_cand)

    from boslam_tpu.mapping.map_state import recompute_covis

    st = state._replace(
        kf_obs_pt=obs, pt_valid=state.pt_valid & ~merged_away
    )
    return recompute_covis(st)


@functools.partial(jax.jit, static_argnums=(0,))
def close_loop_update(cfg: SlamConfig, state: MapState, kf_id, cand, t_rel,
                      match_idx, match_ok, pose_cw, ref):
    """The whole loop correction as ONE device function (reference
    correct_loop, §3.4): fuse duplicated points, record the loop edge,
    rigidly move the current keyframe to satisfy it, optimize the essential
    graph, propagate the correction to map points.

    ``pose_cw`` is the live camera pose and ``ref`` its reference keyframe
    slot.  Returns (MapState, camera pose [7]): the camera keeps its pose
    relative to ``ref`` and moves with ref's correction.  The correction
    lands frames after ``kf_id`` was inserted, so the camera is no longer
    at kf_id.  Fused and jitted it is one dispatch instead of a host-driven
    chain of small device calls.
    """
    t_cur_ref = se3.pose_compose(pose_cw, se3.pose_inv(state.kf_pose[ref]))
    state = fuse_loop_points(cfg, state, kf_id, cand, match_idx, match_ok)
    state = add_loop_edge(state, kf_id, cand, t_rel)
    edges = build_essential_edges(cfg, state)
    corrected = se3.pose_compose(t_rel, state.kf_pose[cand])
    init = state.kf_pose.at[kf_id].set(corrected)
    K = init.shape[0]
    fixed = jnp.zeros(K, bool).at[0].set(True).at[cand].set(True)
    new_poses = optimize_pose_graph(cfg, init, state.kf_valid, edges, fixed)
    state = apply_pose_correction(cfg, state, new_poses)
    return state, se3.pose_compose(t_cur_ref, state.kf_pose[ref])


def add_loop_edge(state: MapState, kf_i, kf_j, t_rel) -> MapState:
    """Record a verified loop edge (measured T_i · T_j^-1)."""
    n = state.n_loop_edges
    cap = state.loop_edges.shape[0]
    slot = jnp.minimum(n, cap - 1)
    return state._replace(
        loop_edges=state.loop_edges.at[slot].set(
            jnp.stack([kf_i, kf_j]).astype(jnp.int32)
        ),
        loop_rel=state.loop_rel.at[slot].set(t_rel),
        n_loop_edges=jnp.minimum(n + 1, cap),
    )
