"""Multi-sequence data-parallel SLAM engine (BASELINE config 5: N camera
sequences in parallel, one per mesh 'seq' shard).

The WHOLE fused frame step — feature extraction, tracking, the keyframe
event (insert + fuse + cull + local BA), loop detection — runs under
``shard_map`` over the 'seq' axis: each device owns one sequence's MapState/
LoopState/TrackState and sees per-shard SCALAR decisions, so the lax.cond
keyframe/loop branches stay real branches (a vmap would execute local BA for
every sequence on every frame).  No communication crosses 'seq'; XLA compiles
the step once for all shards (SPMD).

Host-mediated rare events (vocabulary training, loop closure) are batched:
one vmapped jitted call updates all sequences with per-sequence do-masks —
the states never leave the device mesh.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from boslam_tpu.config import SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.loopclosure import empty_loop_state, train_vocab, verify_loop
from boslam_tpu.mapping import empty_map
from boslam_tpu.slam import (
    O_CULL0, O_KF, O_KFID, O_LCAND, O_LCONS, O_LOST, O_NINL, O_NKF, O_POSE0,
    O_REF, O_REFSEQ, O_REL0, O_STATUS, OUT_DIM, frame_step_core,
)
from boslam_tpu.solvers.pose_graph import close_loop_update
from boslam_tpu.tracking import init_track_state


def seq_mesh(n_seq: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices[:n_seq]), ("seq",))


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


@functools.lru_cache(maxsize=8)
def make_batched_step(cfg: SlamConfig, mesh: Mesh):
    """Jitted shard_map'd frame step over [S]-batched engine states.
    Cached by (cfg, mesh) so fresh engines reuse the compiled executable.

    ``act`` [S] bool gates each shard: real sequences have unequal lengths
    (BASELINE config 5 runs 4 TUM sequences in parallel), so a finished
    sequence rides along as a no-op branch — its state is untouched and its
    row is ignored by the host (lax.cond keeps the skip REAL: a finished
    shard does no feature/tracking work)."""

    def body(ms, ls, tr, key, img, d16, act):
        sq = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)

        def run(ms, ls, tr, key):
            return frame_step_core(cfg, ms, ls, tr, key, img[0], d16[0])

        def skip(ms, ls, tr, key):
            row = jnp.zeros((OUT_DIM,), jnp.float32).at[O_KFID].set(-1.0)
            row = row.at[O_LCAND].set(-1.0)
            row = row.at[O_CULL0].set(-1.0)
            return ms, ls, tr, key, row

        ms, ls, tr, k, row = jax.lax.cond(
            act[0], run, skip, sq(ms), sq(ls), sq(tr), key[0]
        )
        ex = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
        return ex(ms), ex(ls), ex(tr), k[None], row[None]

    spec = P("seq")
    step = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec,) * 7, out_specs=(spec,) * 5,
        check_vma=False,
    )
    return jax.jit(step, donate_argnums=(0, 1, 2, 3))


@functools.lru_cache(maxsize=8)
def make_batched_events(cfg: SlamConfig, mesh: Mesh):
    """One jitted call covering both rare host events for ALL sequences:
    vocabulary (re)training and verified loop correction, gated per
    sequence by do-masks (states stay sharded on the mesh)."""

    def one(ms, ls, tr, key, vocab_do, kf_id, cand, loop_do):
        new_ls = train_vocab(cfg, ls, ms)
        ls = jax.tree_util.tree_map(
            lambda a, b: jnp.where(vocab_do, a, b), new_ls, ls
        )
        ok, t_rel, n_inl, midx, mok = verify_loop(cfg, ms, kf_id, cand, key)
        ok = ok & loop_do & (cand >= 0)
        new_ms, pose_cw = close_loop_update(
            cfg, ms, kf_id, jnp.clip(cand, 0, None), t_rel, midx, mok,
            tr.pose_cw, tr.last_kf,
        )
        ms = jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok, a, b), new_ms, ms
        )
        tr = tr._replace(
            pose_cw=jnp.where(ok, pose_cw, tr.pose_cw),
            velocity=jnp.where(ok, se3.pose_identity(), tr.velocity),
        )
        return ms, ls, tr, ok, n_inl

    def body(ms, ls, tr, keys, vocab_do, kf_id, cand, loop_do):
        sq = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
        out = one(sq(ms), sq(ls), sq(tr), keys[0], vocab_do[0], kf_id[0],
                  cand[0], loop_do[0])
        return jax.tree_util.tree_map(lambda x: x[None], out)

    spec = P("seq")
    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(spec,) * 8, out_specs=(spec,) * 5,
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1, 2))


class BatchedSlamSystem:
    """S independent RGBD SLAM engines, one per 'seq' mesh shard.

    ``feed(ts_list, rgbs, depths)`` advances every sequence by one frame
    (lists of length S); ``flush()`` drains the packed [T, S, OUT_DIM] stats
    and runs the batched host events.  Mirrors SlamSystem's interface
    per-sequence via ``metrics[s]`` / ``trajectory(s)``.
    """

    def __init__(self, cfg: SlamConfig, n_seq: int, mesh: Mesh = None,
                 seed: int = 0, chunk: int = 8):
        self.cfg = cfg
        self.n_seq = n_seq
        self.mesh = mesh if mesh is not None else seq_mesh(n_seq)
        assert self.mesh.shape["seq"] == n_seq
        self.chunk = max(1, int(chunk))
        shard = NamedSharding(self.mesh, P("seq"))
        put = lambda tree: jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard), tree
        )
        self.map = put(_stack([empty_map(cfg) for _ in range(n_seq)]))
        self.loop = put(_stack([empty_loop_state(cfg) for _ in range(n_seq)]))
        self.track = put(_stack([init_track_state() for _ in range(n_seq)]))
        self.key = put(jax.random.split(jax.random.key(seed), n_seq))
        self._shard = shard
        self._step = make_batched_step(cfg, self.mesh)
        self._events = make_batched_events(cfg, self.mesh)
        self.metrics: List[List[dict]] = [[] for _ in range(n_seq)]
        self.timestamps: List[List[float]] = [[] for _ in range(n_seq)]
        self.poses_twc: List[List[np.ndarray]] = [[] for _ in range(n_seq)]
        self.frame_refs: List[List[tuple]] = [[] for _ in range(n_seq)]
        self.n_loops_closed = [0] * n_seq
        # Per-sequence cull chains (see SlamSystem.cull_chain).
        self.cull_chain = [dict() for _ in range(n_seq)]
        self._vocab_trained_at = [-1] * n_seq
        self._pending_rows: List[jnp.ndarray] = []
        self._pending_ts: List[List[float]] = []
        self._pending_act: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def feed(self, ts_list, rgbs, depths, active=None) -> None:
        """Advance sequences by one frame (async dispatch).

        ``active`` [S] bools (default all True): inactive shards are no-ops
        on device and produce no host records — how unequal-length sequence
        batches run to each sequence's own end (run_sequences)."""
        from boslam_tpu.slam import depth_wire, to_gray_u8

        if active is None:
            active = [True] * self.n_seq
        active = np.asarray(active, bool)

        imgs, d16s = [], []
        cam = self.cfg.camera
        for rgb, depth in zip(rgbs, depths):
            if rgb.ndim == 3:
                img = to_gray_u8(rgb)
            else:
                img = rgb.astype(np.uint8)
            if depth.dtype != np.uint16 or depth.shape != cam.depth_wire_shape:
                # Same wire reduction as SlamSystem.feed: the frontend
                # indexes depth at the wire stride, so full-res depth here
                # would read the wrong quadrant.
                depth = depth_wire(depth, cam)
            imgs.append(img)
            d16s.append(depth)
        img_b = jax.device_put(np.stack(imgs), self._shard)
        d16_b = jax.device_put(np.stack(d16s), self._shard)
        act_b = jax.device_put(active, self._shard)
        self.map, self.loop, self.track, self.key, rows = self._step(
            self.map, self.loop, self.track, self.key, img_b, d16_b, act_b
        )
        rows.copy_to_host_async()
        self._pending_rows.append(rows)
        self._pending_ts.append(list(ts_list))
        self._pending_act.append(active)
        if len(self._pending_rows) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        if not self._pending_rows:
            return
        rows_t = np.stack([np.asarray(r) for r in self._pending_rows])
        ts_t = self._pending_ts
        act_t = self._pending_act
        self._pending_rows, self._pending_ts, self._pending_act = [], [], []

        lc = self.cfg.loop
        vocab_do = np.zeros(self.n_seq, bool)
        # Per-sequence queue of (kf_id, cand, rec): ALL consistent candidates
        # from this drain are verified in order until one closes — the single
        # engine's policy (slam.flush) — and each verification result is
        # recorded on the metrics rec whose row raised O_LCONS, not on the
        # chunk's last rec.
        loop_queue = [[] for _ in range(self.n_seq)]
        for s in range(self.n_seq):
            last_active_t = -1
            for t, ts in enumerate(ts_t):
                if not act_t[t][s]:
                    continue  # finished sequence: no-op shard, no record
                last_active_t = t
                r = rows_t[t, s]
                self.timestamps[s].append(ts[s])
                self.poses_twc[s].append(r[O_POSE0:O_POSE0 + 7].copy())
                self.frame_refs[s].append(
                    (int(r[O_REF]), int(r[O_REFSEQ]),
                     r[O_REL0:O_REL0 + 7].copy())
                )
                if r[O_CULL0] >= 0:
                    self.cull_chain[s][
                        (int(r[O_CULL0]), int(r[O_CULL0 + 1]))
                    ] = (int(r[O_CULL0 + 2]), int(r[O_CULL0 + 3]),
                         r[O_CULL0 + 4:O_CULL0 + 11].copy())
                rec = {
                    "ts": ts[s],
                    "status": int(r[O_STATUS]),
                    "n_inliers": int(r[O_NINL]),
                    "lost": bool(r[O_LOST] > 0.5),
                }
                if r[O_KF] > 0.5:
                    rec["event"] = "keyframe" if r[O_KFID] > 0 else "init"
                    rec["kf_id"] = int(r[O_KFID])
                if r[O_LCONS] > 0.5:
                    loop_queue[s].append((int(r[O_KFID]), int(r[O_LCAND]), rec))
                self.metrics[s].append(rec)
            if last_active_t < 0:
                continue  # sequence saw no frames this drain
            n_kf = int(rows_t[last_active_t, s, O_NKF])
            due = (
                (self._vocab_trained_at[s] < 0 and n_kf >= lc.vocab_train_kf)
                or (self._vocab_trained_at[s] >= 0
                    and n_kf - self._vocab_trained_at[s] >= lc.vocab_refresh_kf)
            )
            if due:
                vocab_do[s] = True
                self._vocab_trained_at[s] = n_kf

        # Drain the queues in rounds: each round submits at most one candidate
        # per sequence to the batched events call; a sequence stops once a
        # closure succeeds (later candidates referenced the pre-correction
        # map).  Vocabulary training rides the first round only.
        done = np.zeros(self.n_seq, bool)
        first_round = True
        round_no = 0
        while vocab_do.any() or any(
            q and not done[s] for s, q in enumerate(loop_queue)
        ):
            loop_do = np.zeros(self.n_seq, bool)
            kf_ids = np.zeros(self.n_seq, np.int32)
            cands = np.full(self.n_seq, -1, np.int32)
            recs = [None] * self.n_seq
            for s in range(self.n_seq):
                if loop_queue[s] and not done[s]:
                    kf_ids[s], cands[s], recs[s] = loop_queue[s].pop(0)
                    loop_do[s] = True
            # Per-sequence event keys derived from a host counter (rare path).
            base = jax.random.fold_in(
                jax.random.key(7), len(self.metrics[0]) * 64 + round_no
            )
            round_no += 1
            keys = jax.device_put(
                jax.random.split(base, self.n_seq), self._shard
            )
            self.map, self.loop, self.track, closed, n_inl = self._events(
                self.map, self.loop, self.track, keys,
                jax.device_put(vocab_do if first_round
                               else np.zeros(self.n_seq, bool), self._shard),
                jax.device_put(kf_ids, self._shard),
                jax.device_put(cands, self._shard),
                jax.device_put(loop_do, self._shard),
            )
            vocab_do = np.zeros(self.n_seq, bool)
            first_round = False
            closed = np.asarray(closed)
            n_inl = np.asarray(n_inl)
            for s in range(self.n_seq):
                if loop_do[s] and recs[s] is not None:
                    recs[s]["loop_inliers"] = int(n_inl[s])
                    if closed[s]:
                        self.n_loops_closed[s] += 1
                        recs[s]["event"] = "loop_closed"
                        done[s] = True

    # ------------------------------------------------------------------
    def trajectory(self, s: int):
        """Anchored trajectory of sequence ``s`` (see SlamSystem.trajectory);
        culled reference keyframes resolve through the per-sequence cull
        chain exactly like the single engine."""
        self.flush()
        ts = np.asarray(self.timestamps[s])
        raw = np.stack(self.poses_twc[s])
        from boslam_tpu.utils.trajectory import anchor_trajectory

        out = anchor_trajectory(
            raw, self.frame_refs[s], self.cull_chain[s],
            np.asarray(self.map.kf_pose[s]), np.asarray(self.map.kf_valid[s]),
            np.asarray(self.map.kf_seq[s]),
        )
        return ts, out

    def n_keyframes(self, s: int) -> int:
        return int(jnp.sum(self.map.kf_valid[s]))

    def n_points(self, s: int) -> int:
        return int(jnp.sum(self.map.pt_valid[s]))


def run_sequences(cfg: SlamConfig, frame_lists, mesh: Mesh = None,
                  seed: int = 0, chunk: int = 8) -> BatchedSlamSystem:
    """Run S sequences in lockstep; ``frame_lists[s]`` = [(ts, rgb, depth)].

    Sequences may have UNEQUAL lengths (real TUM runs do): every sequence
    runs to its own end; finished sequences ride as no-op shards via the
    per-shard done-mask (their last frame is re-fed as a placeholder but the
    device branch skips it and the host records nothing)."""
    n_seq = len(frame_lists)
    T = max(len(f) for f in frame_lists)
    eng = BatchedSlamSystem(cfg, n_seq, mesh=mesh, seed=seed, chunk=chunk)
    for t in range(T):
        idx = [min(t, len(frame_lists[s]) - 1) for s in range(n_seq)]
        active = [t < len(frame_lists[s]) for s in range(n_seq)]
        ts = [frame_lists[s][idx[s]][0] for s in range(n_seq)]
        rgbs = [frame_lists[s][idx[s]][1] for s in range(n_seq)]
        depths = [frame_lists[s][idx[s]][2] for s in range(n_seq)]
        eng.feed(ts, rgbs, depths, active=active)
    eng.flush()
    return eng
