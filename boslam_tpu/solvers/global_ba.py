"""Global bundle adjustment: all keyframes + all landmarks, matrix-free PCG.

BASELINE config 4 ("dense keyframe map, 50k+ landmark global BA"): at global
scale the reduced camera system outgrows a dense factorization, so the Schur
complement is applied *matrix-free* inside preconditioned conjugate gradient
(SURVEY.md §7.1 step 7):

    S x = (H_cc + lam D) x − W H_pp^-1 W^T x

**Scatter-free reductions (r4 redesign).**  The original operator paid
three scatter-add `segment_sum`s over the 131k edges per CG application;
both reduction directions are restructured around the edge list's layout
instead:

- *Camera side*: the global edge list IS the flattened ``[K, N]`` keypoint
  table (one edge per keyframe x keypoint slot), so camera reductions are a
  reshape + dense sum over the N axis — no scatter, ~free.
- *Point side*: edges are pre-sorted by point id ONCE per solve; a sorted
  segment sum is then an exclusive ``cumsum`` + two boundary gathers
  (``cs[ends] - cs[starts]``), and the sort is amortized over every LM
  iteration x CG application.

**Adaptive inner solves.**  The CG loop exits on a relative-residual
tolerance (inexact-Newton forcing) instead of always running its full
iteration cap.  (An exact Schur-diagonal preconditioner bought nothing
over damped-Hcc block-Jacobi at equal CG budgets; see ``_assemble``.)

Landmark back-substitution is the same shard-local formula as local BA.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.mapping.map_state import MapState
from boslam_tpu.solvers import ba_core
from boslam_tpu.solvers.ba_core import BaEdges
from boslam_tpu.solvers import robust as robust_mod


class GlobalBaStats(NamedTuple):
    cost0: jnp.ndarray
    cost1: jnp.ndarray
    n_edges: jnp.ndarray


def build_global_edges(cfg: SlamConfig, state: MapState) -> BaEdges:
    """Every (keyframe, keypoint-slot) observation is an edge; cameras are
    global keyframe ids, points are global point ids.  The edge order is
    the row-major flattened ``[K, N]`` table — ``cam[e] == e // N`` — which
    the solver exploits for scatter-free camera reductions."""
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    obs = state.kf_obs_pt
    valid = (
        (obs >= 0)
        & state.kf_valid[:, None]
        & state.kf_kp_valid
        & state.pt_valid[jnp.clip(obs, 0, P - 1)]
    )
    cam_idx = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    depth = state.kf_depth
    return BaEdges(
        cam=cam_idx.reshape(-1).astype(jnp.int32),
        pt=jnp.clip(obs.reshape(-1), 0, P - 1).astype(jnp.int32),
        uv=state.kf_uv.reshape(-1, 2),
        depth=depth.reshape(-1),
        has_depth=(depth.reshape(-1) > 0) & valid.reshape(-1),
        info=robust_mod.octave_inv_sigma2(
            state.kf_octave.reshape(-1), cfg.orb.scale_factor
        ),
        valid=valid.reshape(-1),
    )


class _PtSchedule(NamedTuple):
    """Point-reduction schedule: edge permutation sorting by point id
    (invalid edges at the end) + per-point [start, end) ranges."""

    perm: jnp.ndarray      # [E] i32 camera-order index of the e-th sorted edge
    inv_perm: jnp.ndarray  # [E] i32 sorted position of the e-th camera-order edge
    pt_sorted: jnp.ndarray # [E] i32 point id per sorted edge (P = invalid)
    starts: jnp.ndarray    # [P] i32
    ends: jnp.ndarray      # [P] i32


def _point_schedule(edges: BaEdges, P: int) -> _PtSchedule:
    seg = jnp.where(edges.valid, edges.pt, P)
    perm = jnp.argsort(seg)
    inv_perm = jnp.argsort(perm)
    pt_sorted = seg[perm]
    ar = jnp.arange(P)
    return _PtSchedule(
        perm=perm,
        inv_perm=inv_perm,
        pt_sorted=pt_sorted,
        starts=jnp.searchsorted(pt_sorted, ar),
        ends=jnp.searchsorted(pt_sorted, ar, side="right"),
    )


_CS_BLOCK = 128  # two-level cumsum block length (see _point_sum_sorted)


def _point_sum_sorted(sched: _PtSchedule, vals_sorted):
    """Sorted segment sum via TWO-LEVEL exclusive cumsum + boundary gathers.
    ``vals_sorted``: [E, ...] in SORTED edge order -> [P, ...].

    A single global f32 cumsum accumulates error with the global running
    total, so late segments lose up to ~0.5 % relative accuracy at 131k
    edges (ADVICE r4).  Here the scan is split into ``_CS_BLOCK``-long
    blocks: a local cumsum per block plus an exclusive scan of block
    totals, and the segment sum is formed as
    ``(off[be] - off[bs]) + (loc[e] - loc[s])`` — for the common case of a
    segment inside one block the offset difference cancels EXACTLY, so the
    error is set by the block-local partial sums (measured ~100x smaller
    than the global-cumsum form at 131k edges), with no f64 and no scatter.
    """
    shape = vals_sorted.shape
    E = shape[0]
    flat = vals_sorted.reshape(E, -1)
    L = _CS_BLOCK
    pad = (-E) % L
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad, flat.shape[1]),
                                                flat.dtype)])
    B = flat.shape[0] // L
    blk = flat.reshape(B, L, -1)
    loc = jnp.cumsum(blk, axis=1).reshape(B * L, -1)      # inclusive, local
    loc = jnp.concatenate([jnp.zeros_like(loc[:1]), loc]) # [B*L+1] exclusive view
    totals = blk.sum(axis=1)                              # [B, F]
    off = jnp.concatenate(
        [jnp.zeros_like(totals[:1]), jnp.cumsum(totals, axis=0)]
    )                                                     # [B+1, F] exclusive

    def gather(idx):
        # Exclusive-cumsum split at position idx in [0, E]:
        #   S(idx) = off[b] + loc[idx],  b = block of element idx-1
        # (loc is the per-block-LOCAL inclusive cumsum shifted by one, so
        # loc[idx] is already the partial sum within idx's own block; at a
        # block boundary idx=b*L it equals totals[b-1] and off[b-1] is
        # used, giving off[b-1]+totals[b-1] = off[b] exactly).
        b = jnp.where(idx == 0, 0, jnp.maximum(idx - 1, 0) // L)
        return b, loc[idx]

    b_e, loc_e = gather(sched.ends)
    b_s, loc_s = gather(sched.starts)
    # Block-offset difference: exact 0 for same-block segments, the SINGLE
    # stored block total for adjacent blocks (error ~ulp(block total), not
    # ulp(global prefix)); only segments spanning >= 3 blocks (> _CS_BLOCK
    # edges, whose sums are correspondingly large) fall back to the rounded
    # global prefix difference.
    off_diff = jnp.where(
        (b_e == b_s)[:, None],
        0.0,
        jnp.where(
            (b_e == b_s + 1)[:, None],
            totals[jnp.minimum(b_s, B - 1)],
            off[b_e] - off[b_s],
        ),
    )
    out = off_diff + (loc_e - loc_s)
    return out.reshape((sched.starts.shape[0],) + shape[1:])


def _point_sum(sched: _PtSchedule, vals):
    """[E, ...] camera-order values -> [P, ...] per-point sums."""
    return _point_sum_sorted(sched, vals[sched.perm])


def _cam_sum(vals, K: int, N: int):
    """[E, ...] camera-order values -> [K, ...] per-camera sums (dense)."""
    return vals.reshape((K, N) + vals.shape[1:]).sum(axis=1)


def _assemble(cfg: SlamConfig, poses, pts, edges, sched, opt_cam_mask, lam,
              delta, K, N):
    """Block terms for the matrix-free Schur operator (scatter-free)."""
    r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
    w, _ = ba_core.robust_weights(cfg, r, edges, delta)
    Jc = jnp.where(opt_cam_mask[edges.cam][:, None, None], J_cam, 0.0)

    wr = w[:, None] * r
    Hcc = _cam_sum(jnp.einsum("eri,erj->eij", Jc, w[:, None, None] * Jc), K, N)
    bc = -_cam_sum(jnp.einsum("eri,er->ei", Jc, wr), K, N)
    Hpp = _point_sum(
        sched, jnp.einsum("eri,erj->eij", J_pt, w[:, None, None] * J_pt)
    )
    bp = -_point_sum(sched, jnp.einsum("eri,er->ei", J_pt, wr))

    eye3 = jnp.eye(3)
    Hpp_d = Hpp + lam * (
        eye3 * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6)[..., None, :]
    ) + 1e-8 * eye3
    Hpp_inv = ba_core.inv3x3(Hpp_d)

    eye6 = jnp.eye(6)
    Hcc_d = Hcc + lam * (
        eye6 * jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6)[..., None, :]
    ) + 1e-7 * eye6

    # Preconditioner: damped-Hcc block-Jacobi.  (The exact Schur diagonal —
    # per-edge W_e Hpp^-1 W_e^T reduced per camera — was measured on the
    # 50k-landmark problem and bought NOTHING: identical converged cost and
    # pose error at the same CG budget, while its [E, 6, 6] per-iteration
    # tensor cost ~60 ms/LM-iter.  Kept out on those grounds.)

    # Sorted-order copies for the point-side half of each CG application.
    Jp_s = J_pt[sched.perm]
    Jc_s = Jc[sched.perm]
    w_s = w[sched.perm]
    return r, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, bc, Hpp_inv, bp


def _schur_matvec(x, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, edges,
                  sched, K, N):
    """y = S x, scatter-free: dense camera reduces + sorted point cumsum."""
    # u_e = w_e (Jc_e x_cam(e)) in camera order ([K, N] broadcast, no gather)
    Jc_kn = Jc.reshape(K, N, 3, 6)
    u = jnp.einsum("knri,ki->knr", Jc_kn, x) * w.reshape(K, N)[..., None]
    b = jnp.einsum("knr,knrj->knj", u, J_pt.reshape(K, N, 3, 3))
    t = _point_sum(sched, b.reshape(-1, 3))                 # [P, 3]
    z = jnp.einsum("pst,pt->ps", Hpp_inv, t)                # [P, 3]
    # back to cameras, in SORTED order (z gather is contiguous per point)
    ze = z[jnp.clip(sched.pt_sorted, 0, z.shape[0] - 1)]
    ze = jnp.where((sched.pt_sorted < z.shape[0])[:, None], ze, 0.0)
    c = jnp.einsum("erj,ej->er", Jp_s, ze) * w_s[:, None]
    d = jnp.einsum("er,eri->ei", c, Jc_s)                   # [E, 6] sorted
    y_cross = _cam_sum(d[sched.inv_perm], K, N)
    y_diag = jnp.einsum("cij,cj->ci", Hcc_d, x)
    return y_diag - y_cross


def _pcg(matvec, b, Minv_blocks, iters: int, rtol: float = 1e-2):
    """Block-Jacobi preconditioned CG on the camera system ([C, 6] layout).

    ``iters`` is a CAP: the loop exits early once the residual norm has
    dropped below ``rtol`` of its start (inexact-Newton forcing — the LM
    step does not need the inner system solved tighter than the outer
    linearization error, and on well-conditioned problems this halves-to-
    quarters the matvec count; a 50k-landmark LM iteration measured cost-
    identical at rtol 1e-2 vs a fixed 40-iteration solve)."""

    def apply_M(r):
        return jnp.einsum("cij,cj->ci", Minv_blocks, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = apply_M(r0)
    rr0 = jnp.sum(r0 * r0)

    def cond(carry):
        x, r, z, p, k = carry
        return (k < iters) & (jnp.sum(r * r) > (rtol * rtol) * rr0)

    def body(carry):
        x, r, z, p, k = carry
        Ap = matvec(p)
        rz = jnp.sum(r * z)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = apply_M(r_new)
        beta = jnp.sum(r_new * z_new) / jnp.maximum(rz, 1e-12)
        p = z_new + beta * p
        return (x, r_new, z_new, p, k + 1)

    x, r, _, _, _ = jax.lax.while_loop(cond, body, (x0, r0, z0, z0, 0))
    return x


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def global_bundle_adjustment(
    cfg: SlamConfig, state: MapState, lm_iters: int = 6, cg_iters: int = 40
):
    """Full-map BA; returns (MapState, GlobalBaStats).  KF0 fixed (gauge)."""
    delta = cfg.local_ba.huber_delta
    C = state.kf_pose.shape[0]
    P = state.pt_xyz.shape[0]
    K, N = state.kf_obs_pt.shape
    edges = build_global_edges(cfg, state)
    sched = _point_schedule(edges, P)  # one sort, amortized over the solve
    opt_cam_mask = state.kf_valid & (jnp.arange(C) > 0)
    poses0 = state.kf_pose
    pts0 = state.pt_xyz
    cost0 = ba_core.robust_cost(cfg, poses0, pts0, edges, delta)

    def lm_iter(carry, _):
        poses, pts, lam, cost = carry
        r, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, bc, Hpp_inv, bp = _assemble(
            cfg, poses, pts, edges, sched, opt_cam_mask, lam, delta, K, N
        )
        # Right-hand side of the reduced system: bc - W Hpp^-1 bp.
        zb = jnp.einsum("pst,pt->ps", Hpp_inv, bp)
        ze = zb[jnp.clip(sched.pt_sorted, 0, P - 1)]
        ze = jnp.where((sched.pt_sorted < P)[:, None], ze, 0.0)
        v = jnp.einsum("erj,ej->er", Jp_s, ze) * w_s[:, None]
        v = jnp.einsum("er,eri->ei", v, Jc_s)
        b_s = bc - _cam_sum(v[sched.inv_perm], K, N)
        b_s = b_s * opt_cam_mask[:, None]

        Minv = _inv6x6(Hcc_d)

        def mv(x):
            x = x * opt_cam_mask[:, None]
            y = _schur_matvec(x, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d,
                              Hpp_inv, edges, sched, K, N)
            return y * opt_cam_mask[:, None] + x * (~opt_cam_mask[:, None])

        dxi = _pcg(mv, b_s, Minv, cg_iters) * opt_cam_mask[:, None]
        # Back-substitute landmarks.
        Jc_kn = Jc.reshape(K, N, 3, 6)
        u = jnp.einsum("knri,ki->knr", Jc_kn, dxi) * w.reshape(K, N)[..., None]
        ub = jnp.einsum("knr,knrj->knj", u, J_pt.reshape(K, N, 3, 3))
        t = _point_sum(sched, ub.reshape(-1, 3))
        dpt = jnp.einsum("pst,pt->ps", Hpp_inv, bp - t)

        new_poses = se3.retract(poses, dxi)
        new_pts = pts + dpt
        new_cost = ba_core.robust_cost(cfg, new_poses, new_pts, edges, delta)
        accept = new_cost < cost
        poses = jnp.where(accept, new_poses, poses)
        pts = jnp.where(accept, new_pts, pts)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
        return (poses, pts, lam, jnp.minimum(new_cost, cost)), None

    (poses, pts, _, cost1), _ = jax.lax.scan(
        lm_iter, (poses0, pts0, jnp.asarray(1e-4), cost0), None, length=lm_iters
    )
    new_state = state._replace(
        kf_pose=jnp.where(opt_cam_mask[:, None], poses, state.kf_pose),
        pt_xyz=jnp.where(state.pt_valid[:, None], pts, state.pt_xyz),
    )
    return new_state, GlobalBaStats(cost0, cost1, jnp.sum(edges.valid))


def _inv6x6(M):
    """Batched 6x6 inverse (block-Jacobi preconditioner blocks)."""
    return jnp.linalg.inv(M + 1e-6 * jnp.eye(6))
