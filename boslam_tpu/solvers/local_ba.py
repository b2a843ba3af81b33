"""Local bundle adjustment over the covisibility window, Schur-complement LM.

Reference contract (SURVEY.md §3.3 local_ba + §3.5): optimize the covisible
keyframes of the newest keyframe and all their map points, with a fixed
second ring; assemble the block-sparse normal equations, eliminate landmark
blocks via the Schur complement, solve the reduced camera system, back-
substitute, inside an accept/reject LM damping loop.

Static dense layout (SURVEY.md §7.1 step 5):
- static window: N_OPT optimized + N_FIX fixed cameras, compacted active
  landmark set of MAX_LOCAL points (jnp.nonzero with static size);
- the edge set is exactly one edge per (window camera, local point), so it
  lives as a dense [C, L] grid (DenseEdges): every normal-equation block —
  Hcc, Hpp, bc, bp and the camera-point coupling A [L, N_OPT, 6, 3] — is a
  plain einsum reduction, with NO scatters or segment_sums inside the LM
  loop (one inversion scatter at build time);
- the Schur reduction  S = H_cc - sum_p A H_pp^-1 A^T  is two einsums
  (batched matmuls); the reduced system is a dense (N_OPT*6)^2 Cholesky.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import camera as cam_mod
from boslam_tpu.geometry import se3
from boslam_tpu.mapping.map_state import MapState
from boslam_tpu.solvers import robust as robust_mod
from boslam_tpu.solvers.ba_core import inv3x3


class LocalBaStats(NamedTuple):
    cost0: jnp.ndarray
    cost1: jnp.ndarray
    n_edges: jnp.ndarray
    n_points: jnp.ndarray


def _select_window(cfg: SlamConfig, state: MapState, center):
    """(opt_ids [KO], opt_mask, fix_ids [KF], fix_mask) keyframe windows."""
    KO = cfg.local_ba.n_opt_kf
    KF_ = cfg.local_ba.n_fixed_kf
    K = state.covis.shape[0]
    row = state.covis[center] * state.kf_valid
    row = row.at[center].set(0)
    w, ids = jax.lax.top_k(row, KO - 1)
    opt_ids = jnp.concatenate([center[None], ids])
    opt_mask = jnp.concatenate([jnp.ones(1, bool), w > 0])
    opt_mask = opt_mask & state.kf_valid[opt_ids]
    # Keyframe 0 anchors the gauge: never optimized.
    opt_cam_mask = opt_mask & (opt_ids != 0)

    # Fixed ring: most covisible with the window, not already in it.
    in_opt = jnp.zeros(K, bool).at[jnp.where(opt_mask, opt_ids, K)].set(
        True, mode="drop"
    )
    in_opt = in_opt.at[opt_ids[0]].set(True)
    ring = jnp.sum(
        state.covis[opt_ids] * opt_mask[:, None], axis=0
    ) * state.kf_valid
    ring = jnp.where(in_opt, 0, ring)
    # KF0 joins the fixed set whenever it sees window points.
    wf, fix_ids = jax.lax.top_k(ring, KF_)
    fix_mask = (wf > 0) & state.kf_valid[fix_ids]
    return opt_ids, opt_mask, opt_cam_mask, fix_ids, fix_mask


class DenseEdges(NamedTuple):
    """Dense [C, L] edge grid: one (possible) edge per window camera x
    local point.  Every edge of the sparse problem IS such a pair, so this
    layout is exact — and it removes all scatters/segment-sums from the LM
    iteration: Hpp/bc/bp/A become plain einsum reductions over the grid.
    """

    uv: jnp.ndarray        # [C, L, 2] measured pixels
    depth: jnp.ndarray     # [C, L] measured keypoint depth (0 = none)
    has_depth: jnp.ndarray # [C, L] bool
    info: jnp.ndarray      # [C, L] per-octave information weight
    valid: jnp.ndarray     # [C, L] bool


def _build_problem(cfg: SlamConfig, state: MapState, center):
    """Compacted cameras, points, and the dense [C, L] edge grid."""
    L = cfg.local_ba.max_local_points
    P = state.pt_xyz.shape[0]
    opt_ids, opt_mask, opt_cam_mask, fix_ids, fix_mask = _select_window(
        cfg, state, center
    )
    cam_ids = jnp.concatenate([opt_ids, fix_ids])          # [C]
    cam_mask = jnp.concatenate([opt_mask, fix_mask])
    poses = state.kf_pose[cam_ids]

    # Active points: observed by the optimized window.
    obs_opt = state.kf_obs_pt[opt_ids]                     # [KO, N]
    obs_opt = jnp.where((obs_opt >= 0) & opt_mask[:, None], obs_opt, P)
    active = jnp.zeros(P + 1, bool).at[obs_opt.reshape(-1)].set(True)
    active = active[:P] & state.pt_valid
    local_ids, = jnp.nonzero(active, size=L, fill_value=P)  # [L] -> global
    slot_used = local_ids < P
    inv = jnp.full(P + 1, -1, jnp.int32).at[jnp.clip(local_ids, 0, P)].set(
        jnp.where(slot_used, jnp.arange(L, dtype=jnp.int32), -1), mode="drop"
    )
    pts = state.pt_xyz[jnp.clip(local_ids, 0, P - 1)]       # [L, 3]

    # Invert each camera's observation row into pt_slot[c, l] = keypoint
    # slot of local point l in camera c (-1 if unobserved): ONE scatter at
    # build time; the LM loop then runs scatter-free.  A point can sit in
    # two slots of one row; the scatter keeps the higher slot by max, which
    # is order-independent (a plain set would keep an arbitrary one on a
    # GPU).
    C, N = cam_ids.shape[0], state.kf_obs_pt.shape[1]
    obs = state.kf_obs_pt[cam_ids]                          # [C, N]
    pl = inv[jnp.clip(obs, 0, P)]                           # [C, N] local pt
    ok = (
        (obs >= 0)
        & (pl >= 0)
        & cam_mask[:, None]
        & state.kf_kp_valid[cam_ids]
    )
    tgt = jnp.where(ok, pl, L)
    pt_slot = jnp.full((C, L + 1), -1, jnp.int32).at[
        jnp.broadcast_to(jnp.arange(C)[:, None], (C, N)), tgt
    ].max(
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (C, N)),
        mode="drop",
    )[:, :L]                                                # [C, L]
    has_e = (pt_slot >= 0) & slot_used[None, :]
    sl = jnp.clip(pt_slot, 0, N - 1)[..., None]             # [C, L, 1]
    uv = jnp.take_along_axis(state.kf_uv[cam_ids], sl, axis=1)
    depth = jnp.take_along_axis(state.kf_depth[cam_ids], sl[..., 0], axis=1)
    octave = jnp.take_along_axis(state.kf_octave[cam_ids], sl[..., 0], axis=1)
    edges = DenseEdges(
        uv=uv,
        depth=depth,
        has_depth=(depth > 0) & has_e,
        info=robust_mod.octave_inv_sigma2(octave, cfg.orb.scale_factor),
        valid=has_e,
    )
    return (
        cam_ids, cam_mask, opt_cam_mask, poses, local_ids, slot_used, pts, edges
    )


def _dense_residuals(cfg: SlamConfig, poses, pts, edges: DenseEdges):
    """Residuals r [C, L, 3] + Jacobians (J_cam [C, L, 3, 6],
    J_pt [C, L, 3, 3]) on the dense grid; poses broadcast per camera row
    (no per-edge pose gather)."""
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    xc = se3.pose_apply(poses[:, None, :], pts[None, :, :])   # [C, L, 3]
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - edges.uv
    r_z = jnp.where(edges.has_depth, w_d * (xc[..., 2] - edges.depth), 0.0)
    r = jnp.concatenate([r_uv, r_z[..., None]], axis=-1)      # [C, L, 3]

    eye = jnp.broadcast_to(jnp.eye(3), xc.shape[:-1] + (3, 3))
    dxc_dxi = jnp.concatenate([-se3.hat(xc), eye], axis=-1)   # [C, L, 3, 6]
    Jp2 = cam_mod.project_jacobian(cam, xc)                   # [C, L, 2, 3]
    R = se3.quat_to_mat(poses[:, None, :4])                   # [C, 1, 3, 3]
    zsel = edges.has_depth[..., None, None]
    J_cam = jnp.concatenate(
        [Jp2 @ dxc_dxi, jnp.where(zsel, w_d * dxc_dxi[..., 2:3, :], 0.0)],
        axis=-2,
    )                                                         # [C, L, 3, 6]
    J_pt = jnp.concatenate(
        [Jp2 @ R, jnp.where(zsel, w_d * R[..., 2:3, :], 0.0)], axis=-2
    )                                                         # [C, L, 3, 3]

    bad = (xc[..., 2] <= 1e-3) | ~edges.valid
    r = jnp.where(bad[..., None], 0.0, r)
    J_cam = jnp.where(bad[..., None, None], 0.0, J_cam)
    J_pt = jnp.where(bad[..., None, None], 0.0, J_pt)
    return r, J_cam, J_pt


def _dense_cost(cfg: SlamConfig, poses, pts, edges: DenseEdges, delta):
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    xc = se3.pose_apply(poses[:, None, :], pts[None, :, :])
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - edges.uv
    r_z = jnp.where(edges.has_depth, w_d * (xc[..., 2] - edges.depth), 0.0)
    chi2 = (jnp.sum(r_uv * r_uv, -1) + r_z * r_z) * edges.info
    ok = edges.valid & (xc[..., 2] > 1e-3)
    return jnp.sum(jnp.where(ok, robust_mod.huber_cost(chi2, delta), 0.0))


def _lm_solve_step(cfg: SlamConfig, poses, pts, edges: DenseEdges,
                   opt_cam_mask, lam):
    """One damped Schur solve: returns (dxi [KO, 6] for opt cams, dpt [L, 3]).

    All normal-equation blocks are plain einsum reductions over the dense
    [C, L] edge grid — no scatters, no segment_sums (the layout guarantees
    one edge per (camera, point) pair).
    """
    KO = cfg.local_ba.n_opt_kf
    L = pts.shape[0]
    delta = cfg.local_ba.huber_delta
    r, J_cam, J_pt = _dense_residuals(cfg, poses, pts, edges)
    chi2 = jnp.sum(r * r, axis=-1) * edges.info              # [C, L]
    w = robust_mod.huber_weight(chi2, delta) * edges.info
    w = jnp.where(edges.valid, w, 0.0)
    sw = jnp.sqrt(w)[..., None]                              # [C, L, 1]

    cam_sel = opt_cam_mask[:KO]
    Gc = J_cam[:KO] * (sw[:KO, :, None] * cam_sel[:, None, None, None])
    Gp = J_pt * sw[..., None]                                # [C, L, 3, 3]
    rw = r * sw                                              # [C, L, 3]

    # Normal-equation contractions run at HIGHEST matmul precision: a
    # reduced-precision default (bf16 or TF32 multiplies) can leave
    # S = Hcc - S_cross slightly indefinite after cancellation, and Cholesky
    # then yields silent NaNs.
    hi = jax.lax.Precision.HIGHEST
    Hcc = jnp.einsum("clri,clrj->cij", Gc, Gc, precision=hi)  # [KO, 6, 6]
    bc = -jnp.einsum("clri,clr->ci", Gc, rw[:KO], precision=hi)  # [KO, 6]
    Hpp = jnp.einsum("clri,clrj->lij", Gp, Gp, precision=hi)  # [L, 3, 3]
    bp = -jnp.einsum("clri,clr->li", Gp, rw, precision=hi)    # [L, 3]
    A = jnp.einsum("clri,clrj->lcij", Gc, Gp[:KO], precision=hi)  # [L, KO, 6, 3]

    # Marquardt damping.
    eye3 = jnp.eye(3)
    Hpp_d = Hpp + lam * (eye3 * jnp.maximum(
        jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6
    )[..., None, :] * eye3) + 1e-8 * eye3
    Hpp_inv = inv3x3(Hpp_d)

    # Schur reduction.
    M = jnp.einsum("pkis,pst->pkit", A, Hpp_inv, precision=hi)  # [L, KO, 6, 3]
    S_cross = jnp.einsum("pait,pbjt->aibj", M, A, precision=hi)  # [KO,6,KO,6]
    S = jnp.zeros((KO, 6, KO, 6))
    S = S.at[jnp.arange(KO), :, jnp.arange(KO), :].add(Hcc)
    S = S - S_cross
    b_s = bc - jnp.einsum("pait,pt->ai", M, bp, precision=hi)   # [KO, 6]

    D = KO * 6
    S = S.reshape(D, D)
    b_s = b_s.reshape(D)
    # Mask out non-optimized camera rows/cols (identity rows).
    m = jnp.repeat(opt_cam_mask.astype(jnp.float32), 6)
    S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    b_s = b_s * m
    diagS = jnp.maximum(jnp.diag(S), 1e-6)
    S = S + lam * jnp.diag(diagS) * jnp.eye(D)
    dxi = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S + 1e-7 * jnp.eye(D)), b_s
    ).reshape(KO, 6)
    dxi = dxi * opt_cam_mask[:, None]

    # Back-substitute points.
    dpt = jnp.einsum(
        "pst,pt->ps", Hpp_inv,
        bp - jnp.einsum("pait,ai->pt", A, dxi, precision=hi),
        precision=hi,
    )
    # A non-finite solve (numerically indefinite Schur system) must not
    # poison the state: skip the step instead.
    finite = jnp.all(jnp.isfinite(dxi)) & jnp.all(jnp.isfinite(dpt))
    return jnp.where(finite, dxi, 0.0), jnp.where(finite, dpt, 0.0)


def _solve_local_ba(cfg: SlamConfig, state: MapState, center):
    """Shared solve core: build the window problem around ``center`` and run
    the LM/GN loop.  Returns (opt_ids [KO], opt_cam_mask, opt_poses [KO, 7],
    local_ids [L], slot_used, pts [L, 3], stats) — the write-back is left to
    the caller (immediate for the inline path, guarded-merge for the
    deferred/asynchronous mapping path)."""
    lb = cfg.local_ba
    KO = lb.n_opt_kf
    P = state.pt_xyz.shape[0]
    (cam_ids, cam_mask, opt_cam_mask, poses, local_ids, slot_used, pts,
     edges) = _build_problem(cfg, state, center)

    cost0 = _dense_cost(cfg, poses, pts, edges, lb.huber_delta)

    if lb.lm_accept_reject:
        # Classic LM: trial-point cost per iteration, accept/reject.
        def lm_iter(carry, _):
            poses, pts, lam, cost = carry
            dxi, dpt = _lm_solve_step(cfg, poses, pts, edges, opt_cam_mask, lam)
            new_opt = se3.retract(poses[:KO], dxi)
            new_poses = jnp.concatenate([new_opt, poses[KO:]])
            new_pts = pts + dpt
            new_cost = _dense_cost(cfg, new_poses, new_pts, edges, lb.huber_delta)
            accept = new_cost < cost
            poses = jnp.where(accept, new_poses, poses)
            pts = jnp.where(accept, new_pts, pts)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam = jnp.clip(lam, 1e-9, 1e3)
            cost = jnp.minimum(new_cost, cost)
            return (poses, pts, lam, cost), None

        (poses, pts, _, _), _ = jax.lax.scan(
            lm_iter, (poses, pts, jnp.asarray(lb.lm_lambda0), cost0), None,
            length=lb.lm_iters,
        )
    else:
        # Damped GN: fixed geometric lambda schedule, every step taken —
        # one linearization + one Schur solve per iteration, no trial pass.
        # Huber IRLS weights keep it robust; RGBD local BA starts from a
        # tracked pose so steps are near-Newton.
        def gn_iter(carry, lam):
            poses, pts = carry
            dxi, dpt = _lm_solve_step(cfg, poses, pts, edges, opt_cam_mask, lam)
            poses = jnp.concatenate(
                [se3.retract(poses[:KO], dxi), poses[KO:]]
            )
            return (poses, pts + dpt), None

        lams = lb.lm_lambda0 * (lb.lm_lambda_decay ** jnp.arange(lb.lm_iters))
        (poses, pts), _ = jax.lax.scan(gn_iter, (poses, pts), lams)

    cost1 = _dense_cost(cfg, poses, pts, edges, lb.huber_delta)

    stats = LocalBaStats(
        cost0=cost0,
        cost1=cost1,
        n_edges=jnp.sum(edges.valid),
        n_points=jnp.sum(slot_used),
    )
    return (
        cam_ids[:KO], opt_cam_mask, poses[:KO], local_ids, slot_used, pts,
        stats,
    )


@functools.partial(jax.jit, static_argnums=(0,))
def local_bundle_adjustment(cfg: SlamConfig, state: MapState, center):
    """Run local BA around keyframe ``center``; returns (MapState, stats).

    The INLINE path: solve and write back in one program (used inside the
    fused frame step's keyframe event and by the batched multi-sequence
    engine)."""
    P = state.pt_xyz.shape[0]
    opt_ids, opt_cam_mask, opt_poses, local_ids, slot_used, pts, stats = (
        _solve_local_ba(cfg, state, center)
    )
    kf_pose = state.kf_pose.at[
        jnp.where(opt_cam_mask, opt_ids, state.kf_pose.shape[0])
    ].set(opt_poses, mode="drop")
    pt_xyz = state.pt_xyz.at[jnp.where(slot_used, local_ids, P)].set(
        pts, mode="drop"
    )
    return state._replace(kf_pose=kf_pose, pt_xyz=pt_xyz), stats


class DeferredBaResult(NamedTuple):
    """Output of an asynchronous local-BA dispatch (the reference's
    local-mapping THREAD, SURVEY.md §3.3, expressed as a second in-flight
    device computation): optimized poses/points plus the identity guards
    needed to merge them into a map that has advanced since the snapshot.

    Guards: ``opt_seq`` is kf_seq at snapshot time (keyframe slots are
    free-list reused after culls — a changed seq means a DIFFERENT keyframe
    now lives in the slot); ``pt_gen`` is pt_first_kf (monotonic n_kf at
    point creation) which uniquely identifies a point slot's tenant."""

    opt_ids: jnp.ndarray    # [KO] i32 optimized keyframe slots
    opt_mask: jnp.ndarray   # [KO] bool
    opt_pose: jnp.ndarray   # [KO, 7] optimized T_cw
    opt_seq: jnp.ndarray    # [KO] i32 kf_seq guard
    pt_ids: jnp.ndarray     # [L] i32 global point slots
    pt_used: jnp.ndarray    # [L] bool
    pt_xyz: jnp.ndarray     # [L, 3] optimized positions
    pt_gen: jnp.ndarray     # [L] i32 pt_first_kf guard
    stats: LocalBaStats


@functools.partial(jax.jit, static_argnums=(0,))
def deferred_local_ba(cfg: SlamConfig, state: MapState, center):
    """Solve local BA around ``center`` WITHOUT writing back: the host
    dispatches this asynchronously at a chunk flush and merges the result
    into the (by then advanced) map at the next flush via
    ``merge_local_ba`` — tracking frames in between run against the pre-BA
    map, exactly the reference's concurrent mapping-thread semantics
    (SURVEY.md §2.3 PP row, §3.3)."""
    P = state.pt_xyz.shape[0]
    opt_ids, opt_cam_mask, opt_poses, local_ids, slot_used, pts, stats = (
        _solve_local_ba(cfg, state, center)
    )
    ids_c = jnp.clip(local_ids, 0, P - 1)
    return DeferredBaResult(
        opt_ids=opt_ids,
        opt_mask=opt_cam_mask,
        opt_pose=opt_poses,
        opt_seq=state.kf_seq[opt_ids],
        pt_ids=local_ids,
        pt_used=slot_used,
        pt_xyz=pts,
        pt_gen=state.pt_first_kf[ids_c],
        stats=stats,
    )


@functools.partial(jax.jit, static_argnums=(0,))
def merge_local_ba(cfg: SlamConfig, state: MapState,
                   res: DeferredBaResult) -> MapState:
    """Merge a deferred local-BA result into the CURRENT map.

    Every write is guarded per entry: a keyframe pose lands only if the
    slot still holds the same keyframe (kf_seq match, still valid); a point
    position lands only if the slot still holds the same point
    (pt_first_kf match, still valid).  Entries culled or slot-reused since
    the snapshot are silently skipped — the reference's mapping thread
    drops updates for erased map entities the same way."""
    K = state.kf_pose.shape[0]
    P = state.pt_xyz.shape[0]
    kf_ok = (
        res.opt_mask
        & state.kf_valid[res.opt_ids]
        & (state.kf_seq[res.opt_ids] == res.opt_seq)
    )
    kf_pose = state.kf_pose.at[jnp.where(kf_ok, res.opt_ids, K)].set(
        res.opt_pose, mode="drop"
    )
    ids_c = jnp.clip(res.pt_ids, 0, P - 1)
    pt_ok = (
        res.pt_used
        & state.pt_valid[ids_c]
        & (state.pt_first_kf[ids_c] == res.pt_gen)
    )
    pt_xyz = state.pt_xyz.at[jnp.where(pt_ok, res.pt_ids, P)].set(
        res.pt_xyz, mode="drop"
    )
    return state._replace(kf_pose=kf_pose, pt_xyz=pt_xyz)
