"""Distributed Schur bundle adjustment over a device mesh.

The BASELINE north-star's distributed design: "distributed BA performing
Schur-complement reduction of per-shard Hessian blocks via psum/all-gather
collectives" — landmark blocks and their observation edges are sharded over
the mesh axis ``pt``; camera poses are replicated.  Each shard assembles its
partial camera-block contributions locally; one ``psum`` reduces
the tiny [KO*6, KO*6] Schur system; every device solves it redundantly
(cheaper than a gather/scatter round-trip) and back-substitutes its own
landmark shard.  Cross-shard covisibility needs no halo exchange because an
edge lives with its landmark and cameras are replicated (SURVEY.md §5.7/5.8).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.solvers import ba_core
from boslam_tpu.solvers.ba_core import BaEdges
from boslam_tpu.solvers import robust as robust_mod


def _local_partials(cfg: SlamConfig, poses, pts, edges, opt_cam_mask, lam):
    """Per-shard assembly: everything before the cross-shard reduction.

    Returns (Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp): the first four are
    partial sums to be psum'd; the last three stay shard-local.
    """
    KO = opt_cam_mask.shape[0]
    L = pts.shape[0]
    delta = cfg.local_ba.huber_delta
    r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
    w, _ = ba_core.robust_weights(cfg, r, edges, delta)

    is_opt = (edges.cam < KO) & opt_cam_mask[jnp.clip(edges.cam, 0, KO - 1)]
    Jc = jnp.where(is_opt[:, None, None], J_cam, 0.0)
    wJc = w[:, None, None] * Jc
    wJp = w[:, None, None] * J_pt

    seg_c = jnp.where(is_opt, edges.cam, KO)
    Hcc = jax.ops.segment_sum(
        jnp.einsum("eri,erj->eij", Jc, wJc), seg_c, num_segments=KO + 1
    )[:KO]
    bc = jax.ops.segment_sum(
        -jnp.einsum("eri,er->ei", Jc, w[:, None] * r), seg_c, num_segments=KO + 1
    )[:KO]
    seg_p = jnp.where(edges.valid, edges.pt, L)
    Hpp = jax.ops.segment_sum(
        jnp.einsum("eri,erj->eij", J_pt, wJp), seg_p, num_segments=L + 1
    )[:L]
    bp = jax.ops.segment_sum(
        -jnp.einsum("eri,er->ei", J_pt, w[:, None] * r), seg_p, num_segments=L + 1
    )[:L]
    seg_cp = jnp.where(is_opt, edges.pt * KO + edges.cam, L * KO)
    A = jax.ops.segment_sum(
        jnp.einsum("eri,erj->eij", Jc, wJp), seg_cp, num_segments=L * KO + 1
    )[: L * KO].reshape(L, KO, 6, 3)

    eye3 = jnp.eye(3)
    Hpp_d = Hpp + lam * (
        eye3 * jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6)[..., None, :]
    ) + 1e-8 * eye3
    Hpp_inv = ba_core.inv3x3(Hpp_d)
    hi = jax.lax.Precision.HIGHEST
    M = jnp.einsum("pkis,pst->pkit", A, Hpp_inv, precision=hi)
    S_cross = jnp.einsum("pait,pbjt->aibj", M, A, precision=hi)
    bs_corr = jnp.einsum("pait,pt->ai", M, bp, precision=hi)
    return Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp


def _camera_solve(KO, Hcc, bc, S_cross, bs_corr, opt_cam_mask, lam):
    S = jnp.zeros((KO, 6, KO, 6))
    S = S.at[jnp.arange(KO), :, jnp.arange(KO), :].add(Hcc)
    S = S - S_cross
    b_s = (bc - bs_corr).reshape(KO * 6)
    D = KO * 6
    S = S.reshape(D, D)
    m = jnp.repeat(opt_cam_mask.astype(jnp.float32), 6)
    S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    b_s = b_s * m
    S = S + lam * jnp.diag(jnp.maximum(jnp.diag(S), 1e-6)) * jnp.eye(D)
    dxi = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S + 1e-7 * jnp.eye(D)), b_s
    ).reshape(KO, 6)
    return dxi * opt_cam_mask[:, None]


def make_sharded_ba(cfg: SlamConfig, mesh: Mesh, n_iters: int = 10):
    """Build a jitted distributed LM solver.

    Inputs (leading-axis sharded over mesh axis 'pt'):
      pts [L, 3], edges: BaEdges with E-axis sharded and *shard-local* point
      indices; poses [C, 7] + opt_cam_mask [KO] replicated.

    Returns fn(poses, pts, edges, opt_cam_mask) -> (poses, pts, cost0, cost1).
    """
    KO = cfg.local_ba.n_opt_kf
    delta = cfg.local_ba.huber_delta

    espec = BaEdges(*(P("pt") for _ in BaEdges._fields))

    def body(poses, pts, edges, opt_cam_mask):
        def cost_of(poses, pts):
            local = ba_core.robust_cost(cfg, poses, pts, edges, delta)
            return jax.lax.psum(local, "pt")

        cost0 = cost_of(poses, pts)

        def lm_iter(carry, _):
            poses, pts, lam, cost = carry
            Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp = _local_partials(
                cfg, poses, pts, edges, opt_cam_mask, lam
            )
            # THE collective: reduce per-shard Schur contributions.
            Hcc, bc, S_cross, bs_corr = jax.lax.psum(
                (Hcc, bc, S_cross, bs_corr), "pt"
            )
            dxi = _camera_solve(KO, Hcc, bc, S_cross, bs_corr, opt_cam_mask, lam)
            dpt = jnp.einsum(
                "pst,pt->ps", Hpp_inv, bp - jnp.einsum("pait,ai->pt", A, dxi)
            )
            new_poses = jnp.concatenate(
                [se3.retract(poses[:KO], dxi), poses[KO:]]
            )
            new_pts = pts + dpt
            new_cost = cost_of(new_poses, new_pts)
            accept = new_cost < cost
            poses = jnp.where(accept, new_poses, poses)
            pts = jnp.where(accept, new_pts, pts)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
            return (poses, pts, lam, jnp.minimum(new_cost, cost)), None

        (poses, pts, _, cost1), _ = jax.lax.scan(
            lm_iter,
            (poses, pts, jnp.asarray(cfg.local_ba.lm_lambda0), cost0),
            None,
            length=n_iters,
        )
        return poses, pts, cost0, cost1

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P("pt"), espec, P()),
        out_specs=(P(), P("pt"), P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def shard_edges_by_point(edges: BaEdges, n_pts: int, n_shards: int):
    """Host-side repartition: round-robin stripe points over shards and group
    edges with their landmark's shard, with local point re-indexing.

    Point p lives on shard p % n_shards at local index p // n_shards.
    Returns (edges_sharded [n_shards * E_cap], perm for pts) where E_cap is
    the max per-shard edge count (padded with invalid edges).
    """
    import numpy as np

    cam = np.asarray(edges.cam)
    pt = np.asarray(edges.pt)
    valid = np.asarray(edges.valid)
    E = cam.shape[0]
    shard = pt % n_shards
    local = pt // n_shards
    e_cap = 0
    buckets = []
    for s in range(n_shards):
        sel = np.where((shard == s) & valid)[0]
        buckets.append(sel)
        e_cap = max(e_cap, len(sel))
    # pad to equal size
    out = {f: [] for f in BaEdges._fields}
    for s, sel in enumerate(buckets):
        pad = e_cap - len(sel)
        idx = np.concatenate([sel, np.zeros(pad, np.int64)])
        padmask = np.concatenate([np.ones(len(sel), bool), np.zeros(pad, bool)])
        out["cam"].append(cam[idx])
        out["pt"].append(local[idx])
        out["uv"].append(np.asarray(edges.uv)[idx])
        out["depth"].append(np.asarray(edges.depth)[idx])
        out["has_depth"].append(np.asarray(edges.has_depth)[idx] & padmask)
        out["info"].append(np.asarray(edges.info)[idx])
        out["valid"].append(np.asarray(edges.valid)[idx] & padmask)
    cat = {k: jnp.asarray(np.concatenate(v)) for k, v in out.items()}
    return BaEdges(**cat), e_cap


def stripe_points(pts: jnp.ndarray, n_shards: int):
    """[L, 3] -> striped layout so shard s holds points p ≡ s (mod n_shards).

    With jax.device_put over NamedSharding(P('pt')) the first L/n rows land
    on shard 0, so we permute p -> (p % n, p // n) ordering first.
    """
    import numpy as np

    L = pts.shape[0]
    perm = np.argsort(np.arange(L) % n_shards, kind="stable")
    return pts[jnp.asarray(perm)], perm
