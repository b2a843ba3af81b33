"""SLAM system orchestrator (reference slam.py / main.py, SURVEY.md §3.1).

The reference runs tracking / local-mapping / loop-closing as three Python
threads around a lock-protected map (SURVEY.md §2.3).  Here the map is an
immutable pytree and the ENTIRE per-frame pipeline — feature extraction,
the init/track/relocalize status switch, the keyframe event (insert + fuse
+ cull + local BA) and BoW loop detection — is ONE jitted, buffer-donating
device function (`_fused_frame_step`).  The host never blocks per frame:
it async-dispatches a chunk of frames and reads back one packed stats
matrix per chunk, so the host never waits on the device per frame.

Rare, host-mediated events (one-time vocabulary training, loop-closure
verification + pose-graph correction) are triggered from the drained chunk
stats — the same asynchronous, delayed semantics as the reference's
loop-closing worker thread (§3.4).

Async local mapping (``SlamSystem(async_mapping=True)`` or
``mapping_device=``) re-creates the reference's local-mapping THREAD
(§3.3): the keyframe event pays insert/fuse/cull only, and the local-BA
solve runs as a separate in-flight device computation merged at the next
flush under per-entry identity guards (solvers/local_ba.deferred_local_ba /
merge_local_ba).
"""

from __future__ import annotations

import functools
import time
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.features import extract_features
from boslam_tpu.geometry import se3
from boslam_tpu.loopclosure import (
    compute_bow, detect_loop, empty_loop_state, train_vocab,
    verify_loops_batch,
)
from boslam_tpu.mapping import empty_map, map_ops
from boslam_tpu.solvers.local_ba import (
    LocalBaStats, deferred_local_ba, local_bundle_adjustment, merge_local_ba,
)
from boslam_tpu.solvers.pose_graph import close_loop_update
from boslam_tpu.tracking import init_track_state, relocalize, track_frame
from boslam_tpu.tracking.tracker import ST_LOST, ST_OK, ST_UNINIT

_BT601 = np.asarray([0.299, 0.587, 0.114], np.float32)

try:  # cv2's SIMD cvtColor is ~9x faster than the numpy BT.601 matmul.
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None


def to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """Host-side u8 RGB -> u8 BT.601 gray (the engine wire format)."""
    if _cv2 is not None:
        return _cv2.cvtColor(rgb, _cv2.COLOR_RGB2GRAY)
    # np.rint matches cv2's round-half-to-even: without it the two paths
    # differ by 1 LSB and engine input depends on whether cv2 is installed.
    return np.rint(rgb.astype(np.float32) @ _BT601).astype(np.uint8)


def depth_to_u16(depth: np.ndarray, depth_factor: float) -> np.ndarray:
    """Host-side f32 metres -> u16 at the TUM depth encoding (wire format)."""
    buf = depth * np.float32(depth_factor)
    np.clip(buf, 0, 65535, out=buf)
    return buf.astype(np.uint16)


def depth_wire(depth: np.ndarray, cam) -> np.ndarray:
    """Host-side depth (f32 metres or u16 counts) -> wire-format u16 of
    shape ``cam.depth_wire_shape``.

    stride 1 is plain quantization.  stride s > 1 ships one sample per s x s
    block with a BOUNDARY-AWARE reduction instead of ``depth[::s, ::s]``:
    the medoid of the block's valid samples picks one surface, then samples
    within 5% of it (same surface, sensor-noise apart) are averaged.  A
    plain strided subsample reads up to s-1 px away from the keypoint and
    picks the far side of object boundaries — foreground/background depth
    mixing that cost ~0.1 m ATE on the r3 hall bench (VERDICT r3 item 2);
    the medoid never mixes surfaces, and same-surface blocks average noise
    down by ~sqrt(n).
    """
    if depth.dtype != np.uint16:
        depth = depth_to_u16(depth, cam.depth_factor)
    s = cam.depth_wire_stride
    if s == 1:
        return depth
    hs, ws = cam.depth_wire_shape
    H, W = depth.shape
    buf = np.zeros((hs * s, ws * s), np.float32)
    buf[:H, :W] = depth
    b = buf.reshape(hs, s, ws, s).transpose(0, 2, 1, 3).reshape(hs, ws, s * s)
    valid = b > 0
    c = valid.sum(-1)
    sv = np.sort(np.where(valid, b, np.inf), axis=-1)
    med = np.take_along_axis(
        sv, (np.maximum(c - 1, 0) // 2)[..., None], axis=-1
    )[..., 0]
    keep = valid & (np.abs(b - med[..., None]) <= 0.05 * med[..., None])
    out = (b * keep).sum(-1) / np.maximum(keep.sum(-1), 1)
    return np.rint(np.where(c > 0, out, 0.0)).astype(np.uint16)

# Packed per-frame output row (f32[OUT_DIM]) — the ONLY device->host data.
O_POSE0 = 0          # [0:7] pose T_wc (w x y z tx ty tz)
O_STATUS = 7         # track status AFTER the frame
O_NINL = 8           # tracking inliers
O_NMATCH = 9         # pre-BA matches
O_NVIS = 10          # map points predicted visible
O_KF = 11            # 1.0 if a keyframe was inserted this frame
O_KFID = 12          # inserted keyframe id (-1)
O_BA0 = 13           # local BA cost before
O_BA1 = 14           # local BA cost after
O_BAE = 15           # local BA edge count
O_LCAND = 16         # loop candidate keyframe id (-1)
O_LSCORE = 17        # loop BoW score
O_LCONS = 18         # 1.0 if temporal consistency passed
O_LOST = 19          # 1.0 if tracking was lost this frame
O_RELOC = 20         # 0 none / 1 reloc attempted+failed / 2 attempted+ok
O_NKF = 21           # keyframe count after the frame
O_REF = 22           # reference keyframe slot of this frame
O_REFSEQ = 23        # kf_seq of that slot (detects later slot reuse)
O_REL0 = 24          # [24:31] T_cur_ref = T_cw(frame) ∘ T_wc(ref keyframe):
                     # lets the host re-anchor past frames to CORRECTED
                     # keyframe poses at dump time (reference trajectory
                     # dump policy — frames ride their reference KF)
O_CULL0 = 31         # [31:42] cull chain record (map_ops.cull_one_keyframe):
                     # [victim_slot(-1 = none), victim_seq, parent_slot,
                     # parent_seq, T_victim_parent(7)] — the host keeps the
                     # chain so frames anchored to culled keyframes still
                     # resolve to a live corrected keyframe at dump time
OUT_DIM = 42


def frame_step_core(cfg: SlamConfig, map_state,
                    loop_state, track, key, img, depth_u16,
                    inline_ba: bool = True):
    """Process one RGBD frame fully on device (pure function).

    The single-sequence engine jits this as ``_fused_frame_step``; the
    multi-sequence engine (parallel/multi.py, BASELINE config 5) runs it
    under ``shard_map`` over the mesh 'seq' axis — per-shard scalars keep
    the lax.cond keyframe/loop branches REAL branches instead of vmap's
    execute-both-sides select.

    Returns (map', loop', track', key', row[OUT_DIM] f32).  All
    data-dependent control flow (status switch, keyframe decision, loop
    detection) is lax.switch / lax.cond — the host sees only the packed
    row (SURVEY.md §7.0: decisions come back as scalars, compute stays
    masked on device).

    Frames arrive in their compact wire format — u8 gray and u16 depth at
    the TUM depth_factor encoding (the host converts RGB to gray: 3x fewer
    bytes to transfer) — and are upcast on device.
    """
    gray = img.astype(jnp.float32)
    depth = depth_u16.astype(jnp.float32) * (1.0 / cfg.camera.depth_factor)
    feats = extract_features(gray, depth, cfg)
    key, sub = jax.random.split(key)
    n = cfg.orb.n_features

    def base_row(tr):
        return (
            jnp.zeros((OUT_DIM,), jnp.float32)
            .at[O_KFID].set(-1.0)
            .at[O_LCAND].set(-1.0)
            .at[O_CULL0].set(-1.0)  # victim slot: -1 = nothing culled
            .at[O_STATUS].set(tr.status.astype(jnp.float32))
        )

    # ---- branch 0: first frame — init map from RGBD depth (§3.2) -------
    def init_branch(ms, ls, tr):
        mp = jnp.full((n,), -1, jnp.int32)
        ok = jnp.zeros((n,), bool)
        ms, _ = map_ops.insert_keyframe(
            cfg, ms, feats, se3.pose_identity(), mp, ok, tr.frame_idx
        )
        tr = tr._replace(
            status=jnp.asarray(ST_OK, jnp.int32), frame_idx=tr.frame_idx + 1
        )
        row = base_row(tr).at[O_KF].set(1.0).at[O_KFID].set(0.0)
        return ms, ls, tr, row

    # ---- branch 2: lost — global relocalization (§3.2 lost path) -------
    def lost_branch(ms, ls, tr):
        tr, good, n_inl = relocalize(cfg, ms, ls, tr, feats, sub)
        row = (
            base_row(tr)
            .at[O_NINL].set(n_inl.astype(jnp.float32))
            .at[O_RELOC].set(jnp.where(good, 2.0, 1.0))
        )
        return ms, ls, tr, row

    # ---- branch 1: nominal tracking + conditional keyframe event -------
    def ok_branch(ms, ls, tr):
        tr, out = track_frame(cfg, ms, tr, feats)
        ms = map_ops.update_track_stats(
            cfg, ms, out.visible, out.match_pt, out.match_ok
        )
        # No hard free-slot gate: a saturated pool evicts its lowest-value
        # keyframe inside the event (map_ops.evict_for_slot, SURVEY §7.2
        # overflow policy) so long non-redundant trajectories keep
        # inserting keyframes at bounded capacity.  The residual guard
        # covers only degenerate pools (< 3 live keyframes can't evict:
        # root and the latest are protected).
        can_kf = out.need_kf & ~out.lost & (
            ~jnp.all(ms.kf_valid) | (jnp.sum(ms.kf_valid) >= 3)
        )

        def kf_event(ms, ls, tr):
            """Local-mapping + place-recognition work for a new keyframe
            (reference §3.3/§3.4, fused into the frame step)."""
            ms, evict_info = map_ops.evict_for_slot(cfg, ms)
            evicted = evict_info[0] >= 0
            st, kf_id = map_ops.insert_keyframe(
                cfg, ms, feats, out.pose_cw, out.match_pt, out.match_ok,
                tr.frame_idx,
            )
            st = map_ops.fuse_new_keyframe(cfg, st, kf_id)
            st = map_ops.refresh_point_model(cfg, st, kf_id)
            st = map_ops.cull_points(cfg, st, update_covis=False)
            if inline_ba:
                st, ba = local_bundle_adjustment(cfg, st, kf_id)
            else:
                # Async-mapping mode (SURVEY.md §2.3 PP row): the BA solve
                # is dispatched by the HOST as a separate device call at the
                # chunk flush and merged at the next one — the keyframe
                # frame itself pays only insert/fuse/cull, like the
                # reference's tracking thread.
                z = jnp.zeros((), jnp.float32)
                ba = LocalBaStats(z, z, jnp.zeros((), jnp.int32),
                                  jnp.zeros((), jnp.int32))
            # One cull record per frame row: if saturation eviction fired,
            # report IT and skip the redundancy cull this event (a freshly
            # saturated pool rarely holds a >=90%-redundant keyframe; the
            # next event reclaims one if so).
            st, cull_info = jax.lax.cond(
                evicted,
                lambda s: (s, evict_info),
                lambda s: map_ops.cull_one_keyframe(cfg, s),
                st,
            )
            ls = compute_bow(cfg, ls, st, kf_id)
            ls, det = detect_loop(cfg, ls, st, kf_id)
            tr = tr._replace(
                last_kf=kf_id,
                n_since_kf=jnp.zeros((), jnp.int32),
                pose_cw=st.kf_pose[kf_id],
            )
            kf_row = jnp.zeros((8,), jnp.float32).at[0].set(1.0)
            kf_row = (
                kf_row.at[1].set(kf_id.astype(jnp.float32))
                .at[2].set(ba.cost0)
                .at[3].set(ba.cost1)
                .at[4].set(ba.n_edges.astype(jnp.float32))
                .at[5].set(det.candidate.astype(jnp.float32))
                .at[6].set(det.score)
                .at[7].set(det.consistent.astype(jnp.float32))
            )
            return st, ls, tr, kf_row, cull_info

        def no_kf(ms, ls, tr):
            kf_row = jnp.zeros((8,), jnp.float32).at[1].set(-1.0).at[5].set(-1.0)
            return ms, ls, tr, kf_row, jnp.zeros((11,), jnp.float32).at[0].set(-1.0)

        ms, ls, tr, kf_row, cull_info = jax.lax.cond(
            can_kf, kf_event, no_kf, ms, ls, tr
        )
        row = (
            base_row(tr)
            .at[O_NINL].set(out.n_inliers.astype(jnp.float32))
            .at[O_NMATCH].set(out.n_matches.astype(jnp.float32))
            .at[O_NVIS].set(out.n_visible.astype(jnp.float32))
            .at[O_LOST].set(out.lost.astype(jnp.float32))
            .at[O_KF].set(kf_row[0])
            .at[O_KFID].set(kf_row[1])
            .at[O_BA0].set(kf_row[2])
            .at[O_BA1].set(kf_row[3])
            .at[O_BAE].set(kf_row[4])
            .at[O_LCAND].set(kf_row[5])
            .at[O_LSCORE].set(kf_row[6])
            .at[O_LCONS].set(kf_row[7])
        )
        row = jax.lax.dynamic_update_slice(row, cull_info, (O_CULL0,))
        return ms, ls, tr, row

    map_state, loop_state, track, row = jax.lax.switch(
        track.status, [init_branch, ok_branch, lost_branch],
        map_state, loop_state, track,
    )
    pose_twc = se3.pose_inv(track.pose_cw)
    ref = track.last_kf
    rel = se3.pose_compose(track.pose_cw, se3.pose_inv(map_state.kf_pose[ref]))
    row = (
        jax.lax.dynamic_update_slice(row, pose_twc, (O_POSE0,))
        .at[O_NKF].set(map_state.n_kf.astype(jnp.float32))
        .at[O_REF].set(ref.astype(jnp.float32))
        .at[O_REFSEQ].set(map_state.kf_seq[ref].astype(jnp.float32))
    )
    row = jax.lax.dynamic_update_slice(row, rel, (O_REL0,))
    return map_state, loop_state, track, key, row


_fused_frame_step = functools.partial(
    jax.jit, static_argnums=(0, 7), donate_argnums=(1, 2, 3, 4)
)(frame_step_core)


@functools.partial(jax.jit, static_argnums=(0, 7), donate_argnums=(1, 2, 3, 4))
def _fused_frame_scan(cfg: SlamConfig, map_state, loop_state, track, key,
                      imgs, depths_u16, inline_ba: bool = True):
    """``frame_step_core`` scanned over a stacked batch of frames on device.

    One H2D transfer and one dispatch per BATCH instead of per frame, which
    removes the per-frame transfer and dispatch overhead from the host.
    Semantically identical to feeding the frames one by one and flushing
    after (host events are flush-mediated either way).  Returns
    (map', loop', track', key', rows [k, OUT_DIM])."""

    def body(carry, inp):
        ms, ls, tr, k = carry
        img, d16 = inp
        ms, ls, tr, k, row = frame_step_core(
            cfg, ms, ls, tr, k, img, d16, inline_ba
        )
        return (ms, ls, tr, k), row

    (map_state, loop_state, track, key), rows = jax.lax.scan(
        body, (map_state, loop_state, track, key), (imgs, depths_u16)
    )
    return map_state, loop_state, track, key, rows


@functools.partial(jax.jit, static_argnums=(0,))
def _merge_ba_and_reanchor(cfg: SlamConfig, map_state, track, res):
    """Apply one deferred local-BA result and re-anchor the live tracker
    pose to its reference keyframe's REFINED pose (the inline path gets
    this for free by setting pose_cw from the post-BA keyframe; without it
    the tracker keeps integrating from pre-BA geometry)."""
    from boslam_tpu.mapping.map_state import latest_kf_slot

    ref = latest_kf_slot(map_state)
    t_cur_ref = se3.pose_compose(
        track.pose_cw, se3.pose_inv(map_state.kf_pose[ref])
    )
    new_map = merge_local_ba(cfg, map_state, res)
    track = track._replace(
        pose_cw=se3.pose_compose(t_cur_ref, new_map.kf_pose[ref])
    )
    return new_map, track


class SlamSystem:
    """Sequential RGBD SLAM engine over one camera stream.

    ``feed()`` async-dispatches a frame; ``flush()`` drains the packed
    per-frame stats in one readback and runs host-mediated events (vocab
    training, loop verification).  ``process_frame()`` is the synchronous
    compatibility wrapper (feed + flush every frame).
    """

    def __init__(self, cfg: SlamConfig, seed: int = 0, chunk: int = 16,
                 ba_mesh=None, async_mapping: bool = False,
                 mapping_device=None):
        self.cfg = cfg
        self.chunk = max(1, int(chunk))
        # Async mapping (reference's local-mapping THREAD, SURVEY.md §3.3):
        # the keyframe event in the fused step does insert/fuse/cull only;
        # the local-BA solve is dispatched as a SEPARATE device computation
        # at the chunk flush and merged (guarded per-entry) at the next one,
        # so tracking frames never serialize behind the solve.  With
        # ``mapping_device`` the solves run on ANOTHER device entirely
        # (true tracking/mapping overlap — two in-flight computations).
        # Trade-off on a single chip: the device stream is serial, so async
        # mode reorders rather than removes the BA cost; it smooths
        # keyframe-frame latency for real-time feeds (BA fills inter-frame
        # idle gaps) at the price of tracking against a map whose BA
        # refinement lands up to two chunks late (~1-2 mm ATE on the orbit
        # fixture).  Default is the fully-fused inline path.
        self.async_mapping = bool(async_mapping) or mapping_device is not None
        self.mapping_device = mapping_device
        # Optional jax.sharding.Mesh with a 'pt' axis: global BA (the loop-
        # closure hook and run_global_ba) runs landmark-sharded over it
        # (parallel/sharded_global_ba) instead of single-device.
        self.ba_mesh = ba_mesh
        self.map = empty_map(cfg)
        self.loop = empty_loop_state(cfg)
        self.track = init_track_state()
        self.key = jax.random.key(seed)
        self.timestamps: List[float] = []
        self.poses_twc: List[np.ndarray] = []
        # Per frame: (ref kf slot, kf_seq at record time, T_cur_ref [7]).
        self.frame_refs: List[tuple] = []
        # Cull chain: (victim_slot, victim_seq) -> (parent_slot, parent_seq,
        # T_victim_parent [7]) — frames anchored to culled keyframes chase
        # this at dump time (reference: erased KFs keep Tcp to parent).
        self.cull_chain: dict = {}
        self.metrics: List[dict] = []
        self.n_loops_closed = 0
        self.n_global_ba = 0
        self._vocab_trained_at = -1  # n_kf at last vocabulary (re)train
        # In-flight deferred local BA: (result, n_loops_closed at dispatch,
        # n_global_ba at dispatch, triggering keyframe's metric rec).
        self._pending_ba = None
        # In-flight loop verification batch (resolved at the NEXT flush so
        # the frame path never blocks on its readback) + a host-side mirror
        # of each keyframe slot's current seq (maintained from the packed
        # rows: inserts and culls) used to guard stale closures without a
        # device read.
        self._pending_verify = None
        self._kf_seq_host: dict = {}
        self._pending_rows: List[jnp.ndarray] = []
        self._pending_ts: List[float] = []
        self._pending_t0: List[float] = []

    # ------------------------------------------------------------------
    def feed(self, ts: float, rgb: np.ndarray, depth: np.ndarray) -> None:
        """Async-dispatch one RGBD frame; no device synchronization.

        ``rgb`` may be [H, W, 3] u8 RGB or an [H, W] grayscale image;
        ``depth`` may be f32 metres or raw u16 at the camera depth_factor.
        Conversion to the engine's f32 working format happens on device —
        the host only quantizes (cheap casts) to the compact wire format.
        """
        t0 = time.perf_counter()
        if rgb.ndim == 3:
            # BT.601 gray on host: 3x fewer wire bytes than u8 RGB (the
            # H2D link is the scarce resource).
            img = jnp.asarray(to_gray_u8(rgb))
        else:
            img = jnp.asarray(
                rgb if rgb.dtype == np.uint8 else
                np.clip(rgb, 0, 255).astype(np.uint8)
            )
        cam = self.cfg.camera
        if depth.dtype != np.uint16 or depth.shape != cam.depth_wire_shape:
            # Full-res input: quantize + boundary-aware block reduction.
            # Already-wire-format u16 (e.g. bench-prepared frames) ships
            # as-is, keeping dataset prep out of the measured loop.
            depth = depth_wire(depth, cam)
        d16 = jnp.asarray(np.ascontiguousarray(depth))
        self.map, self.loop, self.track, self.key, row = _fused_frame_step(
            self.cfg, self.map, self.loop, self.track, self.key, img, d16,
            not self.async_mapping,
        )
        # Start the D2H copy of the stats row NOW, without blocking: by
        # flush() time the bytes are already on the host, so the drain
        # does not wait on a transfer.
        row.copy_to_host_async()
        self._pending_rows.append(row)
        self._pending_ts.append(ts)
        self._pending_t0.append(t0)
        if len(self._pending_rows) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def feed_batch(self, batch) -> None:
        """Feed a list of ``(ts, rgb, depth)`` frames as ONE stacked H2D
        transfer + ONE scanned device dispatch (``_fused_frame_scan``).

        The offline/dataset throughput mode: per-frame ``feed()`` pays one
        transfer + one dispatch per frame.  Semantics match
        feeding the same frames singly and flushing afterwards — host
        events (vocab, loop verify, deferred BA) are flush-mediated in
        both paths.  A distinct batch length compiles its own executable,
        so callers should feed FIXED-size batches (see run_sequence).
        """
        if not batch:
            return
        cam = self.cfg.camera
        imgs, d16s = [], []
        for ts, rgb, depth in batch:
            if rgb.ndim == 3:
                g = to_gray_u8(rgb)
            else:
                g = (rgb if rgb.dtype == np.uint8 else
                     np.clip(rgb, 0, 255).astype(np.uint8))
            if depth.dtype != np.uint16 or depth.shape != cam.depth_wire_shape:
                depth = depth_wire(depth, cam)
            imgs.append(g)
            d16s.append(depth)
            self._pending_ts.append(ts)
            # Batch frames share one dispatch, so a per-frame wall latency
            # is not meaningful — t0=None marks the rec as batch-mode and
            # flush() skips dt_ms instead of reporting an inflated value
            # (ADVICE r4).
            self._pending_t0.append(None)
        self.map, self.loop, self.track, self.key, rows = _fused_frame_scan(
            self.cfg, self.map, self.loop, self.track, self.key,
            jnp.asarray(np.stack(imgs)),
            jnp.asarray(np.ascontiguousarray(np.stack(d16s))),
            not self.async_mapping,
        )
        rows.copy_to_host_async()
        self._pending_rows.append(rows)
        if len(self._pending_ts) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Drain pending frames: ONE packed readback, then host events."""
        if not self._pending_rows:
            # End-of-stream: land the last solve + close the last loop.
            self._merge_pending_ba()
            self._resolve_pending_verify()
            return
        # Entries are [OUT_DIM] rows (feed) or [k, OUT_DIM] blocks
        # (feed_batch).
        rows = np.concatenate(
            [np.atleast_2d(np.asarray(r)) for r in self._pending_rows]
        )
        ts_list, t0_list = self._pending_ts, self._pending_t0
        self._pending_rows, self._pending_ts, self._pending_t0 = [], [], []
        t_drain = time.perf_counter()

        # Land the PREVIOUS flush's deferred BA before anything reads poses
        # this drain (loop verification must see the refined window).
        self._merge_pending_ba()

        loop_requests = []  # (kf_id, cand) — try in order, one CLOSURE per drain
        kf_recs = []        # keyframe events this drain (async-mapping queue)
        for ts, t0, r in zip(ts_list, t0_list, rows):
            self.timestamps.append(ts)
            self.poses_twc.append(r[O_POSE0:O_POSE0 + 7].copy())
            self.frame_refs.append(
                (int(r[O_REF]), int(r[O_REFSEQ]), r[O_REL0:O_REL0 + 7].copy())
            )
            if r[O_CULL0] >= 0:
                self.cull_chain[(int(r[O_CULL0]), int(r[O_CULL0 + 1]))] = (
                    int(r[O_CULL0 + 2]), int(r[O_CULL0 + 3]),
                    r[O_CULL0 + 4:O_CULL0 + 11].copy(),
                )
                self._kf_seq_host[int(r[O_CULL0])] = None  # slot vacated
            rec = {
                "ts": ts,
                "status": int(r[O_STATUS]),
                "n_inliers": int(r[O_NINL]),
                "n_matches": int(r[O_NMATCH]),
                "n_visible": int(r[O_NVIS]),
                "lost": bool(r[O_LOST] > 0.5),
            }
            if t0 is not None:
                rec["dt_ms"] = (t_drain - t0) * 1e3
            else:
                rec["batch_mode"] = True
            if r[O_RELOC] > 0.5:
                rec["event"] = "relocalize"
                rec["reloc_ok"] = bool(r[O_RELOC] > 1.5)
            elif r[O_LOST] > 0.5:
                rec["event"] = "lost"
            elif r[O_KF] > 0.5:
                kf_id = int(r[O_KFID])
                # Mirror the slot's new tenant (seq assigned at insert =
                # monotonic n_kf before the increment the row reports).
                self._kf_seq_host[kf_id] = int(r[O_NKF]) - 1
                rec["event"] = "init" if kf_id == 0 else "keyframe"
                rec.update(
                    kf_id=kf_id,
                    ba_cost0=float(r[O_BA0]),
                    ba_cost1=float(r[O_BA1]),
                    ba_edges=int(r[O_BAE]),
                )
                if kf_id > 0:
                    kf_recs.append((kf_id, rec))
                if r[O_LCAND] >= 0:
                    rec["loop_candidate"] = int(r[O_LCAND])
                    rec["loop_score"] = float(r[O_LSCORE])
                if r[O_LCONS] > 0.5:
                    # rec rides along so verify results land on the
                    # TRIGGERING keyframe's record, not the chunk's last.
                    loop_requests.append((kf_id, int(r[O_LCAND]), rec))
            self.metrics.append(rec)

        # --- host-mediated events (rare; reference's async workers) ----
        # Vocabulary lifecycle: first training once enough keyframes exist,
        # then periodic refresh so the word table tracks the growing scene
        # (kf_bow rows are recomputed inside train_vocab).
        n_kf = int(rows[-1][O_NKF])
        lc = self.cfg.loop
        due = (
            (self._vocab_trained_at < 0 and n_kf >= lc.vocab_train_kf)
            or (self._vocab_trained_at >= 0
                and n_kf - self._vocab_trained_at >= lc.vocab_refresh_kf)
        )
        if due:
            self.loop = train_vocab(self.cfg, self.loop, self.map)
            self._vocab_trained_at = n_kf
        # Resolve the PREVIOUS drain's verification batch (its readback
        # landed while this chunk was tracking — no sync in the frame
        # path), closing at most one loop, then dispatch this drain's
        # candidates as the next in-flight batch (the reference's
        # loop-closing thread semantics, §3.4).
        self._resolve_pending_verify()
        self._dispatch_verify(loop_requests)

        # Dispatch the deferred local BAs LAST, so they solve on the
        # loop-corrected map.  One solve per keyframe event (the inline
        # path's frequency), chained through a SHADOW map so each solve
        # sees its predecessor's refinement; all results land in the live
        # map at the NEXT flush, while the next chunk's tracking frames are
        # dispatched without waiting on them.
        if self.async_mapping and kf_recs:
            shadow = self.map
            if self.mapping_device is not None:
                # The reference's mapping THREAD as a second device: the
                # solve chain runs there while this device keeps tracking.
                shadow = jax.device_put(shadow, self.mapping_device)
            resses = []
            for kf_id, rec in kf_recs:
                res = deferred_local_ba(
                    self.cfg, shadow, jnp.asarray(kf_id, jnp.int32)
                )
                shadow = merge_local_ba(self.cfg, shadow, res)
                if self.mapping_device is not None:
                    res = jax.device_put(res, jax.devices()[0])
                jax.tree.map(lambda a: a.copy_to_host_async(), res.stats)
                resses.append((res, rec))
            self._pending_ba = (resses, self.n_loops_closed,
                                self.n_global_ba)

    # ------------------------------------------------------------------
    def _merge_pending_ba(self) -> None:
        """Land the in-flight deferred local BAs into the current map.

        Dropped wholesale if a loop closure or global BA ran since the
        dispatch — those moved the whole trajectory, and stale local poses
        would partially revert the correction (the reference pauses its
        mapping thread across loop correction for the same reason).
        Per-entry staleness (culled/reused slots) is handled inside
        ``merge_local_ba`` by the seq/gen guards."""
        if self._pending_ba is None:
            return
        resses, loops0, gba0 = self._pending_ba
        self._pending_ba = None
        if self.n_loops_closed != loops0 or self.n_global_ba != gba0:
            for _, rec in resses:
                rec["ba_dropped"] = True
            return
        for res, rec in resses:
            self.map, self.track = _merge_ba_and_reanchor(
                self.cfg, self.map, self.track, res
            )
            rec.update(
                ba_cost0=float(res.stats.cost0),
                ba_cost1=float(res.stats.cost1),
                ba_edges=int(res.stats.n_edges),
            )

    # ------------------------------------------------------------------
    # Max consistent candidates verified per drain; extras are dropped
    # (they re-fire on the next keyframe if genuine).  Static so the
    # batched verify compiles once.
    MAX_VERIFY = 4

    def _dispatch_verify(self, loop_requests) -> None:
        """Dispatch this drain's candidates in ONE batched verification;
        results are read at the NEXT flush — its readback would otherwise
        cost a device round trip in the frame path every candidate drain."""
        reqs, seen = [], set()
        for kf_id, cand, rec in loop_requests:
            if cand >= 0 and (kf_id, cand) not in seen:
                seen.add((kf_id, cand))
                reqs.append((kf_id, cand, rec))
        reqs = reqs[: self.MAX_VERIFY]
        if not reqs:
            return
        n = len(reqs)
        # Pad to the static batch size by repeating the first request
        # (duplicates are masked out on the host side).
        pad = reqs + [reqs[0]] * (self.MAX_VERIFY - n)
        kf_ids = jnp.asarray([r[0] for r in pad], jnp.int32)
        cands = jnp.asarray([r[1] for r in pad], jnp.int32)
        self.key, k = jax.random.split(self.key)
        ok, t_rel, n_inl, midx, mok = verify_loops_batch(
            self.cfg, self.map, kf_ids, cands,
            jax.random.split(k, self.MAX_VERIFY),
        )
        ok.copy_to_host_async()
        n_inl.copy_to_host_async()
        # Endpoint identity at dispatch, from the host mirror: a slot culled
        # or reused before the resolve must drop the closure.
        guards = [
            (self._kf_seq_host.get(kf), self._kf_seq_host.get(cand))
            for kf, cand, _ in reqs
        ]
        self._pending_verify = (ok, t_rel, n_inl, midx, mok, reqs, guards,
                                self.n_loops_closed, self.n_global_ba)

    def _resolve_pending_verify(self) -> None:
        """Read the previous drain's verification results (bytes landed
        during the chunk) and run at most one pose-graph correction."""
        if self._pending_verify is None:
            return
        (ok, t_rel, n_inl, midx, mok, reqs, guards, loops0, gba0) = (
            self._pending_verify
        )
        self._pending_verify = None
        ok_h, inl_h = np.asarray(ok), np.asarray(n_inl)
        for i, (kf_id, cand, rec) in enumerate(reqs):
            rec["loop_inliers"] = int(inl_h[i])
        if self.n_loops_closed != loops0 or self.n_global_ba != gba0:
            return  # trajectory moved since dispatch; stale measurement
        for i, (kf_id, cand, rec) in enumerate(reqs):
            fresh = (
                guards[i][0] is not None
                and guards[i][1] is not None
                and self._kf_seq_host.get(kf_id) == guards[i][0]
                and self._kf_seq_host.get(cand) == guards[i][1]
            )
            if fresh and bool(ok_h[i]):
                self._close_loop(kf_id, cand, t_rel[i], midx[i], mok[i], rec)
                break

    # ------------------------------------------------------------------
    def process_frame(
        self, ts: float, rgb: np.ndarray, depth: np.ndarray
    ) -> np.ndarray:
        """Synchronous wrapper: feed one frame, flush, return T_wc [7]."""
        self.feed(ts, rgb, depth)
        self.flush()
        return self.poses_twc[-1]

    # ------------------------------------------------------------------
    def _close_loop(self, kf_id: int, cand: int, t_rel, midx, mok,
                    rec=None) -> None:
        """Correct the loop (reference correct_loop, §3.4): point fusion +
        loop edge + essential-graph optimization + map propagation, fused
        into ONE jitted device call (close_loop_update)."""
        cfg = self.cfg
        self.map, pose_cw = close_loop_update(
            cfg, self.map, jnp.asarray(kf_id, jnp.int32),
            jnp.asarray(cand, jnp.int32), t_rel, midx, mok,
            self.track.pose_cw, self.track.last_kf,
        )
        self.track = self.track._replace(
            pose_cw=pose_cw, velocity=se3.pose_identity()
        )
        self.n_loops_closed += 1
        (rec if rec is not None else self.metrics[-1])["event"] = "loop_closed"
        if cfg.loop.run_global_ba:
            # Reference §3.4: optional full-map BA after the pose-graph
            # correction (side thread there; a jitted call here).
            self.run_global_ba()

    # ------------------------------------------------------------------
    def run_global_ba(self) -> dict:
        """Full-map bundle adjustment (BASELINE config 4 hook).

        Runs landmark-sharded over ``self.ba_mesh`` when one with >1 device
        was provided (SURVEY.md §5.8 distributed comm backend; CLI
        ``--distributed``), else on the single default device."""
        cfg = self.cfg
        # Latest keyframe anchors the tracked pose across the solve: keep the
        # frame's RELATIVE pose to it (T_cur_ref = pose_cw ∘ T_wc(ref)) and
        # re-attach to the corrected ref pose — snapping to the keyframe pose
        # outright would discard motion accumulated since that keyframe and
        # jump the camera.
        ref = int(jnp.argmax(jnp.where(self.map.kf_valid, self.map.kf_seq, -1)))
        t_cur_ref = se3.pose_compose(
            self.track.pose_cw, se3.pose_inv(self.map.kf_pose[ref])
        )
        distributed = (
            self.ba_mesh is not None and self.ba_mesh.devices.size > 1
        )
        if distributed:
            from boslam_tpu.parallel.sharded_global_ba import (
                distributed_global_ba,
            )

            self.map, (cost0, cost1, n_edges) = distributed_global_ba(
                cfg, self.ba_mesh, self.map,
                lm_iters=cfg.loop.global_ba_iters,
                cg_iters=cfg.loop.global_ba_cg_iters,
            )
        else:
            from boslam_tpu.solvers.global_ba import global_bundle_adjustment

            self.map, stats = global_bundle_adjustment(
                cfg, self.map,
                lm_iters=cfg.loop.global_ba_iters,
                cg_iters=cfg.loop.global_ba_cg_iters,
            )
            cost0, cost1, n_edges = (
                float(stats.cost0), float(stats.cost1), int(stats.n_edges)
            )
        self.track = self.track._replace(
            pose_cw=se3.pose_compose(t_cur_ref, self.map.kf_pose[ref]),
            velocity=se3.pose_identity(),
        )
        self.n_global_ba += 1
        rec = {
            "gba_cost0": cost0,
            "gba_cost1": cost1,
            "gba_edges": n_edges,
            "gba_distributed": distributed,
        }
        if self.metrics:
            self.metrics[-1].update(rec)
        return rec

    # ------------------------------------------------------------------
    def trajectory(self):
        """(timestamps, poses_twc [T, 7]) with every frame RE-ANCHORED to the
        current pose of its reference keyframe (reference trajectory-dump
        policy): loop-closure / global-BA corrections applied after a frame
        passed still correct that frame's recorded pose.  Frames whose
        reference keyframe was CULLED chase the cull chain (victim ->
        spanning parent -> ... -> live keyframe), composing the relative
        poses recorded at cull time — the reference's erased-keyframe Tcp
        mechanism; only an unresolvable chain falls back to the raw pose."""
        self.flush()
        # A flush may have JUST dispatched these; land them before dumping.
        self._merge_pending_ba()
        self._resolve_pending_verify()
        ts = np.asarray(self.timestamps)
        raw = np.stack(self.poses_twc)
        if len(self.frame_refs) != len(self.poses_twc):
            return ts, raw  # e.g. resumed from a pre-anchoring checkpoint
        from boslam_tpu.utils.trajectory import anchor_trajectory

        out = anchor_trajectory(
            raw, self.frame_refs, self.cull_chain,
            np.asarray(self.map.kf_pose), np.asarray(self.map.kf_valid),
            np.asarray(self.map.kf_seq),
        )
        return ts, out

    @property
    def n_keyframes(self) -> int:
        return int(jnp.sum(self.map.kf_valid))

    @property
    def n_points(self) -> int:
        return int(jnp.sum(self.map.pt_valid))


def run_sequence(
    cfg: SlamConfig,
    frames,
    seed: int = 0,
    progress: bool = False,
    chunk: int = 16,
    async_mapping: bool = False,
    batch: int = 0,
) -> SlamSystem:
    """Run the engine over an iterable of (ts, rgb, depth).

    ``batch > 1`` feeds fixed-size stacked batches (one transfer + one
    scanned dispatch each — the offline throughput mode); the remainder
    frames go through the per-frame path."""
    slam = SlamSystem(cfg, seed=seed, chunk=chunk, async_mapping=async_mapping)
    if batch > 1:
        frames = list(frames)
        n_full = (len(frames) // batch) * batch
        for i in range(0, n_full, batch):
            slam.feed_batch(frames[i:i + batch])
        for ts, rgb, depth in frames[n_full:]:
            slam.feed(ts, rgb, depth)
        slam.flush()
        return slam
    for i, (ts, rgb, depth) in enumerate(frames):
        slam.feed(ts, rgb, depth)
        if progress and i % 25 == 0 and slam.metrics:
            m = slam.metrics[-1]
            print(
                f"[{i}] kf={slam.n_keyframes} pts={slam.n_points} "
                f"inl={m.get('n_inliers', 0)} {m.get('event', '')}"
            )
    slam.flush()
    return slam
