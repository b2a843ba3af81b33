"""Distributed GLOBAL bundle adjustment over the mesh 'pt' axis.

BASELINE config 4/5 composition: the full-map BA edge list (built from the
live MapState's observation table, solvers/global_ba.build_global_edges) is
sharded landmark-wise over the mesh — each device owns a stripe of landmarks
and every observation of them; camera poses are replicated.  One ``psum``
per LM iteration reduces the camera-side normal equations, and every PCG
matvec psums its camera-space output; landmark blocks (Hpp, back-
substitution) never leave their shard.  This is the live-engine counterpart
of parallel/sharded_ba.py's local-window solver.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.mapping.map_state import MapState
from boslam_tpu.solvers import ba_core
from boslam_tpu.solvers.ba_core import BaEdges
from boslam_tpu.solvers.global_ba import (
    _inv6x6, _pcg, _point_schedule, _point_sum, build_global_edges,
)
from boslam_tpu.parallel.sharded_ba import shard_edges_by_point, stripe_points


def make_sharded_global_ba(cfg: SlamConfig, mesh: Mesh, lm_iters: int,
                           cg_iters: int):
    """Jitted distributed global-BA solver.

    fn(poses [C,7] replicated, opt_cam_mask [C] replicated,
       pts [P,3] striped over 'pt', edges BaEdges sharded over 'pt' with
       SHARD-LOCAL point indices)
    -> (poses, pts, cost0, cost1)
    """
    delta = cfg.local_ba.huber_delta

    def body(poses, opt_cam_mask, pts, edges):
        C = poses.shape[0]
        Pl = pts.shape[0]  # local landmark count
        # Shard-local point-reduction schedule (one argsort per solve):
        # the point side then runs scatter-free as sorted cumsum + boundary
        # gathers, exactly like the single-device solver.
        sched = _point_schedule(edges, Pl)

        def cost_of(poses, pts):
            return jax.lax.psum(
                ba_core.robust_cost(cfg, poses, pts, edges, delta), "pt"
            )

        cost0 = cost_of(poses, pts)

        def lm_iter(carry, _):
            poses, pts, lam, cost = carry
            r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
            w, _ = ba_core.robust_weights(cfg, r, edges, delta)
            Jc = jnp.where(
                opt_cam_mask[edges.cam][:, None, None], J_cam, 0.0
            )
            wJc = w[:, None, None] * Jc
            wJp = w[:, None, None] * J_pt
            seg_c = jnp.where(edges.valid, edges.cam, C)
            Hcc = jax.ops.segment_sum(
                jnp.einsum("eri,erj->eij", Jc, wJc), seg_c, num_segments=C + 1
            )[:C]
            bc = jax.ops.segment_sum(
                -jnp.einsum("eri,er->ei", Jc, w[:, None] * r), seg_c,
                num_segments=C + 1,
            )[:C]
            # THE collective: camera-side normal equations.
            Hcc, bc = jax.lax.psum((Hcc, bc), "pt")
            Hpp = _point_sum(
                sched, jnp.einsum("eri,erj->eij", J_pt, wJp)
            )
            bp = -_point_sum(sched, jnp.einsum("eri,er->ei", J_pt,
                                               w[:, None] * r))
            # Sorted-order copies for the CG matvecs.
            Jp_s = J_pt[sched.perm]
            Jc_s = Jc[sched.perm]
            w_s = w[sched.perm]

            eye3 = jnp.eye(3)
            Hpp_d = Hpp + lam * (
                eye3 * jnp.maximum(
                    jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6
                )[..., None, :]
            ) + 1e-8 * eye3
            Hpp_inv = ba_core.inv3x3(Hpp_d)
            eye6 = jnp.eye(6)
            Hcc_d = Hcc + lam * (
                eye6 * jnp.maximum(
                    jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6
                )[..., None, :]
            ) + 1e-7 * eye6

            seg_c_s = seg_c[sched.perm]

            def cam_reduce(z):
                """W^T z gathered to camera space, psum'd: [C, 6] partial.
                Runs in SORTED edge order (the z gather is then contiguous
                per point)."""
                ze = z[jnp.clip(sched.pt_sorted, 0, Pl - 1)]
                ze = jnp.where((sched.pt_sorted < Pl)[:, None], ze, 0.0)
                v = jnp.einsum("erj,ej->er", Jp_s, ze) * w_s[:, None]
                v = jnp.einsum("er,eri->ei", v, Jc_s)
                part = jax.ops.segment_sum(v, seg_c_s, num_segments=C + 1)[:C]
                return jax.lax.psum(part, "pt")

            zb = jnp.einsum("pst,pt->ps", Hpp_inv, bp)
            b_s = (bc - cam_reduce(zb)) * opt_cam_mask[:, None]
            Minv = _inv6x6(Hcc_d)

            def point_half(x):
                """t = sum_e W_e^T x_cam(e) per local point (scatter-free)."""
                xc = x[edges.cam]
                u = jnp.einsum("eri,ei->er", Jc, xc) * w[:, None]
                u = jnp.einsum("er,erj->ej", u, J_pt)
                return _point_sum(sched, u)

            def mv(x):
                x = x * opt_cam_mask[:, None]
                t = point_half(x)
                z = jnp.einsum("pst,pt->ps", Hpp_inv, t)
                y_cross = cam_reduce(z)
                y_diag = jnp.einsum("cij,cj->ci", Hcc_d, x)
                y = y_diag - y_cross
                return y * opt_cam_mask[:, None] + x * (~opt_cam_mask[:, None])

            dxi = _pcg(mv, b_s, Minv, cg_iters) * opt_cam_mask[:, None]
            # Landmark back-substitution stays shard-local.
            t = point_half(dxi)
            dpt = jnp.einsum("pst,pt->ps", Hpp_inv, bp - t)

            new_poses = se3.retract(poses, dxi)
            new_pts = pts + dpt
            new_cost = cost_of(new_poses, new_pts)
            accept = new_cost < cost
            poses = jnp.where(accept, new_poses, poses)
            pts = jnp.where(accept, new_pts, pts)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
            return (poses, pts, lam, jnp.minimum(new_cost, cost)), None

        (poses, pts, _, cost1), _ = jax.lax.scan(
            lm_iter, (poses, pts, jnp.asarray(1e-4), cost0), None,
            length=lm_iters,
        )
        return poses, pts, cost0, cost1

    espec = BaEdges(*(P("pt") for _ in BaEdges._fields))
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("pt"), espec),
        out_specs=(P(), P("pt"), P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def distributed_global_ba(cfg: SlamConfig, mesh: Mesh, state: MapState,
                          lm_iters: int = 6, cg_iters: int = 40):
    """Full-map BA of a LIVE MapState with landmarks sharded over 'pt'.

    Host-side prep: build the observation edge list from the map, stripe
    landmarks over shards, relabel edges with shard-local point indices.
    Returns (MapState, (cost0, cost1, n_edges)).
    """
    C = state.kf_pose.shape[0]
    Pn = state.pt_xyz.shape[0]
    n_shards = mesh.shape["pt"]
    edges = build_global_edges(cfg, state)
    e_sh, _ = shard_edges_by_point(edges, Pn, n_shards)
    pts_sh, perm = stripe_points(state.pt_xyz, n_shards)

    opt_cam_mask = np.asarray(state.kf_valid) & (np.arange(C) > 0)
    fn = make_sharded_global_ba(cfg, mesh, lm_iters, cg_iters)
    pt_shard = NamedSharding(mesh, P("pt"))
    rep = NamedSharding(mesh, P())
    # Route through host numpy: ``state`` may be committed to a DIFFERENT
    # mesh (e.g. the batched engine's 'seq' mesh) than the BA's 'pt' mesh.
    e_sh = jax.tree_util.tree_map(
        lambda x: jax.device_put(np.asarray(x), pt_shard), e_sh
    )
    pts_sh = jax.device_put(np.asarray(pts_sh), pt_shard)
    poses, pts_out, cost0, cost1 = fn(
        jax.device_put(np.asarray(state.kf_pose), rep),
        jax.device_put(opt_cam_mask, rep), pts_sh, e_sh,
    )
    # Un-stripe the landmark stripe back to global order.
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    pt_xyz = np.asarray(pts_out)[inv]
    new_state = state._replace(
        kf_pose=jnp.where(
            jnp.asarray(opt_cam_mask)[:, None], np.asarray(poses),
            state.kf_pose,
        ),
        pt_xyz=jnp.where(state.pt_valid[:, None], pt_xyz, state.pt_xyz),
    )
    return new_state, (float(cost0), float(cost1), int(jnp.sum(edges.valid)))
