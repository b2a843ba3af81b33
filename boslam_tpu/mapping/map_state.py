"""The global map as a fixed-capacity pytree of arrays.

Array-native redesign of the reference's ``covisibility_graph.py``
(``CovisibilityGraph`` / ``KeyFrame`` / ``MapPoint`` object graph with locks,
SURVEY.md §2.1): here the map is pure data — dense arrays with validity masks
and a free-list allocation discipline (SURVEY.md §7.0), so every mutation is a
pure jittable update and the tracking/mapping race class of the reference is
eliminated by construction (SURVEY.md §5.2).

Canonical observation structure: ``kf_obs_pt[k, s]`` = map-point id observed
at keypoint slot ``s`` of keyframe ``k`` (-1 if none).  Covisibility weights,
observation counts, and the spanning tree are derived from it — the
covisibility matrix is one matmul of the keyframe/point incidence matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig

MAX_LOOP_EDGES = 32


class MapState(NamedTuple):
    # --- keyframes ------------------------------------------------------
    kf_pose: jnp.ndarray      # [K, 7] f32 T_cw
    kf_valid: jnp.ndarray     # [K] bool
    kf_uv: jnp.ndarray        # [K, N, 2] f32 keypoint pixels (level-0)
    kf_depth: jnp.ndarray     # [K, N] f32 keypoint depth (0 = none)
    kf_desc: jnp.ndarray      # [K, N, 8] u32 descriptors
    kf_octave: jnp.ndarray    # [K, N] i32
    kf_angle: jnp.ndarray     # [K, N] f32 keypoint orientation (radians)
    kf_kp_valid: jnp.ndarray  # [K, N] bool
    kf_obs_pt: jnp.ndarray    # [K, N] i32 observed point id, -1 = none
    kf_frame_idx: jnp.ndarray # [K] i32 source frame index
    kf_seq: jnp.ndarray       # [K] i32 insertion sequence number (-1 = never used)
    n_kf: jnp.ndarray         # scalar i32 MONOTONIC total insertions (seq source)
    # --- map points -----------------------------------------------------
    pt_xyz: jnp.ndarray       # [P, 3] f32 world positions
    pt_desc: jnp.ndarray      # [P, 8] u32 representative descriptor
    pt_angle: jnp.ndarray     # [P] f32 orientation of the representative observation
    pt_valid: jnp.ndarray     # [P] bool
    pt_ref_kf: jnp.ndarray    # [P] i32 creating keyframe
    pt_first_kf: jnp.ndarray  # [P] i32 n_kf at creation (recency for culling)
    pt_n_vis: jnp.ndarray     # [P] i32 times predicted visible in tracking
    pt_n_found: jnp.ndarray   # [P] i32 times matched as tracking inlier
    # Viewing model (reference MapPoint normal + min/max view distance,
    # SURVEY.md §2.1 Map row): mean viewing direction as an UN-normalized
    # sum of per-observation unit vectors point->camera (world frame;
    # ||sum|| ~ 0 means "no data", gates disable), and the scale-invariance
    # distance band predicted from the observing keypoint's octave.
    pt_dir_sum: jnp.ndarray   # [P, 3] f32 sum of unit view directions
    pt_dmin: jnp.ndarray      # [P] f32 min predicted view distance (0 = unset)
    pt_dmax: jnp.ndarray      # [P] f32 max predicted view distance (0 = unset)
    # --- derived / graph ------------------------------------------------
    covis: jnp.ndarray        # [K, K] i32 co-observation counts (symmetric)
    spanning_parent: jnp.ndarray  # [K] i32 parent keyframe id (-1 for root)
    loop_edges: jnp.ndarray   # [MAX_LOOP_EDGES, 2] i32 keyframe pairs
    loop_rel: jnp.ndarray     # [MAX_LOOP_EDGES, 7] f32 measured T_ci_cj
    n_loop_edges: jnp.ndarray # scalar i32


def empty_map(cfg: SlamConfig) -> MapState:
    K = cfg.map.max_keyframes
    P = cfg.map.max_points
    N = cfg.orb.n_features
    return MapState(
        kf_pose=jnp.zeros((K, 7)).at[:, 0].set(1.0),
        kf_valid=jnp.zeros(K, bool),
        kf_uv=jnp.zeros((K, N, 2)),
        kf_depth=jnp.zeros((K, N)),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_octave=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N)),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_obs_pt=jnp.full((K, N), -1, jnp.int32),
        kf_frame_idx=jnp.zeros(K, jnp.int32),
        kf_seq=jnp.full(K, -1, jnp.int32),
        n_kf=jnp.zeros((), jnp.int32),
        pt_xyz=jnp.zeros((P, 3)),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_angle=jnp.zeros(P),
        pt_valid=jnp.zeros(P, bool),
        pt_ref_kf=jnp.zeros(P, jnp.int32),
        pt_first_kf=jnp.zeros(P, jnp.int32),
        pt_n_vis=jnp.zeros(P, jnp.int32),
        pt_n_found=jnp.zeros(P, jnp.int32),
        pt_dir_sum=jnp.zeros((P, 3)),
        pt_dmin=jnp.zeros(P),
        pt_dmax=jnp.zeros(P),
        covis=jnp.zeros((K, K), jnp.int32),
        spanning_parent=jnp.full(K, -1, jnp.int32),
        loop_edges=jnp.zeros((MAX_LOOP_EDGES, 2), jnp.int32),
        loop_rel=jnp.zeros((MAX_LOOP_EDGES, 7)).at[:, 0].set(1.0),
        n_loop_edges=jnp.zeros((), jnp.int32),
    )


def free_kf_slot(state: MapState):
    """(slot, has_free): first invalid keyframe slot, free-list allocation.

    Slot 0 (the gauge root) is never culled, so a freed slot is always > 0 and
    reuse cannot disturb the gauge anchor.
    """
    free = ~state.kf_valid
    slot = jnp.argmax(free).astype(jnp.int32)
    return slot, free[slot]


def latest_kf_slot(state: MapState):
    """Slot of the most recently inserted valid keyframe (argmax kf_seq)."""
    seq = jnp.where(state.kf_valid, state.kf_seq, -1)
    return jnp.argmax(seq).astype(jnp.int32)


def incidence(state: MapState) -> jnp.ndarray:
    """Keyframe x point observation incidence O[k, p] in {0, 1} (bf16).

    Built by scatter from the canonical kf_obs_pt table; the covisibility
    matrix is then O @ O^T — one matmul instead of the reference's
    per-point Python dict walks.
    """
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    obs = state.kf_obs_pt
    has = (obs >= 0) & state.kf_valid[:, None]
    # Route invalid entries to a dump row (index P).
    tgt = jnp.where(has, obs, P)
    O = jnp.zeros((K, P + 1), jnp.bfloat16)
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    O = O.at[rows, tgt].max(jnp.bfloat16(1.0))
    O = O[:, :P] * state.pt_valid[None, :].astype(jnp.bfloat16)
    return O


def recompute_covis(state: MapState) -> MapState:
    """Refresh covisibility weights + per-point observation counts from the
    canonical observation table."""
    O = incidence(state)
    covis = jnp.dot(O, O.T, preferred_element_type=jnp.float32)
    covis = covis.astype(jnp.int32)
    covis = covis * (1 - jnp.eye(covis.shape[0], dtype=jnp.int32))
    return state._replace(covis=covis)


def point_obs_count(state: MapState) -> jnp.ndarray:
    """[P] i32 — number of valid keyframes observing each point."""
    O = incidence(state)
    return jnp.sum(O.astype(jnp.float32), axis=0).astype(jnp.int32)


def covis_neighbors(state: MapState, kf_id, k: int, min_weight: int):
    """Top-k covisible keyframes of ``kf_id``: (ids [k], weights [k], mask)."""
    row = state.covis[kf_id] * state.kf_valid
    w, ids = jax.lax.top_k(row, k)
    mask = w >= min_weight
    return ids, w, mask
