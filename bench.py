"""Benchmark harness: the BASELINE.json primary metrics on one chip.

Workload (no TUM data ships in this container — SURVEY.md §0):
1. **Tracking** (BASELINE configs 1-3 in one run): 450-frame clover
   trajectory in a hall-sized synthetic room (room_scale 2.5) at VGA
   geometry (640x480, wide-FOV RGBD camera, 512 features, 8 pyramid
   levels, local BA on every keyframe).  Three petals leave and re-enter
   the start region, so the run exercises MULTIPLE loop closures with drift
   (local-scope tracking, the reference's track_local_map policy).
   Reports tracked frames/s/chip (median of up to 3 passes), ATE RMSE,
   loops closed.
2. **Device path + utilization** (in the PRIMARY line): scan-chained
   fused-step ms/frame + XLA cost-analysis FLOPs vs chip peaks.
3. **Global BA kernel scale** (config 4 kernel number): 256 keyframes x
   50k landmarks x 131k observations, matrix-free PCG Schur; LM iters/s
   (median of 3 salted reps).
4. **Accuracy error budget** (cheap subset): ATE with loop closing off
   (drift floor) and on a noise-0 render (intrinsic accuracy without the
   injected sensor noise).  The full stride/noise sweep is `--error-budget`.
5. **Per-stage ms + utilization** (feature / track / local BA) on
   production shapes, scan-diff measured.
6. **Tracked-map global BA** (BASELINE config 4 on ENGINE-BUILT state):
   a 400-frame survey drives the engine to a large map; global BA runs on
   THAT map.  Reports LM iters/s + ATE before/after.

**Time budget:** the harness holds a wall-clock budget (`--budget`,
default 900 s).  The PRIMARY JSON line prints immediately after phase 1
and carries the device-path ceiling + utilization when budget allowed
measuring them; the later phases run in priority order while budget
remains (the error-budget phase only if its fps-derived estimate fits),
and a final JSON line — a strict superset of the primary line — reports
what ran, what was skipped, per-phase seconds, and the per-program warmup
breakdown.

Compile time: the engine's jit programs are persistently cached (see
``boslam_tpu/__init__.py``), and warmup AOT-compiles the rare host-event
programs on WORKER THREADS (XLA compiles release the GIL, so they overlap
the warmup frame feed; the AOT writes prime the persistent cache and the
later in-path retrace hits it).

``vs_baseline`` honesty note: the reference publishes no numbers and its
mount is EMPTY (SURVEY.md §0/§6) so it was never measured; the denominator
is 30 fps — the ORB-SLAM-family real-time CPU tracking rate (PAPERS.md:9),
an UPPER BOUND on the pure-Python reference.  The ratio is therefore a
lower bound on the true speedup.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

BASELINE_FPS = 30.0  # ORB-SLAM family CPU rate — see module docstring.
BATCH = 16           # feed_batch size (offline-throughput mode)

class Budget:
    """Wall-clock budget: phases check ``allow(name, est_s)`` before
    running, where ``est_s`` is an estimate derived from this run's own
    measurements (0 when there is none: the phase runs while any budget
    remains)."""

    def __init__(self, total_s: float):
        self.t0 = time.perf_counter()
        self.total = total_s
        self.skipped = []
        self.phase_times = {}

    def remaining(self) -> float:
        return self.total - (time.perf_counter() - self.t0)

    def allow(self, name: str, est_s: float = 0.0) -> bool:
        rem = self.remaining()
        if rem > 0 and rem >= est_s:
            return True
        self.skipped.append(name)
        print(
            f"[bench] SKIP {name}: est {est_s:.0f}s > {rem:.0f}s remaining",
            file=sys.stderr,
        )
        return False

    def timed(self, name: str):
        budget = self

        class _T:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                budget.phase_times[name] = round(
                    time.perf_counter() - self.t, 1
                )

        return _T()


def _wire(cfg, ts, rgb, depth_f32):
    """Full render -> engine wire format: u8 gray + u16 block-reduced depth.
    Datasets arrive in wire format (the native loader / dataset prep side
    does this conversion); doing it in the measured loop would bill
    dataset-creation work to the engine."""
    from boslam_tpu.slam import depth_wire, to_gray_u8

    return ts, to_gray_u8(rgb), depth_wire(depth_f32, cfg.camera)


class RenderFeed:
    """Background renderer: the main tracking sequence renders frame-by-frame
    (incrementally consumable so engine warmup overlaps the render), then any
    queued extra sequences render to completion.  One thread, sequential —
    render is host numpy and must not contend with itself."""

    def __init__(self, cfg, traj, *, depth_noise, seed, room_scale):
        self.cfg = cfg
        self.frames = []
        self.n_total = len(traj.timestamps)
        self.extra = {}
        self._jobs = []
        self._cv = threading.Condition()
        self._main_args = (traj, depth_noise, seed, room_scale)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def queue(self, name, cfg, traj, *, depth_noise, seed, room_scale):
        with self._cv:
            self._jobs.append((name, cfg, traj, depth_noise, seed, room_scale))
            self._cv.notify_all()

    def _render(self, cfg, traj, depth_noise, seed, room_scale, sink):
        from boslam_tpu.io.synthetic import render_frame

        rng = np.random.default_rng(seed)
        for ts, pose in zip(traj.timestamps, traj.poses_twc):
            rgb, depth = render_frame(cfg.camera, pose, room_scale=room_scale)
            if depth_noise > 0:
                depth = depth + rng.normal(size=depth.shape).astype(
                    np.float32
                ) * (depth_noise * depth)
            frame = _wire(cfg, float(ts), rgb, depth)
            with self._cv:
                sink.append(frame)
                self._cv.notify_all()

    def _work(self):
        traj, noise, seed, scale = self._main_args
        self._render(self.cfg, traj, noise, seed, scale, self.frames)
        while True:
            with self._cv:
                while not self._jobs:
                    self._cv.wait(timeout=1.0)
                name, cfg, traj, noise, seed, scale = self._jobs.pop(0)
                if name is None:
                    return
                sink = self.extra.setdefault(name, [])
            self._render(cfg, traj, noise, seed, scale, sink)
            with self._cv:
                self.extra[name + ":done"] = True
                self._cv.notify_all()

    def get(self, i):
        """Blocking: the i-th main-sequence frame."""
        with self._cv:
            while len(self.frames) < i + 1:
                self._cv.wait()
            return self.frames[i]

    def wait_main(self):
        with self._cv:
            while len(self.frames) < self.n_total:
                self._cv.wait()
            return self.frames

    def wait_extra(self, name, timeout_s=600.0):
        deadline = time.perf_counter() + timeout_s
        with self._cv:
            while not self.extra.get(name + ":done"):
                if time.perf_counter() > deadline:
                    return None
                self._cv.wait(timeout=1.0)
            return self.extra[name]


def _ate(slam, traj):
    import jax.numpy as jnp

    from boslam_tpu.geometry import align

    _, est = slam.trajectory()
    n = min(len(est), len(traj.poses_twc))
    rmse, _ = align.ate_rmse(
        jnp.asarray(est[:n, 4:]), jnp.asarray(traj.poses_twc[:n, 4:])
    )
    return float(rmse)


def _run_engine(cfg, frames, *, loop_off: bool = False):
    """One engine pass over wire-format frames; returns the SlamSystem."""
    from boslam_tpu.slam import SlamSystem

    slam = SlamSystem(cfg)
    if loop_off:
        slam.MAX_VERIFY = 0  # host never verifies -> no closures (drift floor)
    for ts, gray, d16 in frames:
        slam.feed(ts, gray, d16)
    slam.flush()
    return slam


class _AotPrecompiles:
    """Handle for the background AOT compile threads (join + timings)."""

    def __init__(self, threads, times):
        self.threads = threads
        self.times = times

    def join(self, timeout_s: float = 600.0):
        deadline = time.perf_counter() + timeout_s
        for t in self.threads:
            t.join(timeout=max(0.1, deadline - time.perf_counter()))


def _start_aot_precompiles(cfg, include_batch: bool) -> _AotPrecompiles:
    """AOT-lower+compile the rare host-event programs and the batch scan on
    worker threads, overlapping the warmup frame feed (XLA compiles release
    the GIL; only the cheap tracing serializes).  The compiles write the
    persistent cache, so the later in-path calls retrace and hit it —
    turning r4's serial cold-compile chain into overlapped work (VERDICT r4
    item 1)."""
    import jax
    import jax.numpy as jnp

    from boslam_tpu import slam as slam_mod
    from boslam_tpu.loopclosure import (
        empty_loop_state, train_vocab, verify_loops_batch,
    )
    from boslam_tpu.mapping import empty_map
    from boslam_tpu.solvers.pose_graph import close_loop_update
    from boslam_tpu.tracking import init_track_state

    sh = lambda t: jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t
    )
    ms = sh(empty_map(cfg))
    ls = sh(empty_loop_state(cfg))
    tr = sh(init_track_state())
    key = sh(jax.random.key(0))
    m = slam_mod.SlamSystem.MAX_VERIFY
    ids = jax.ShapeDtypeStruct((m,), jnp.int32)
    keys = sh(jax.random.split(jax.random.key(0), m))
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    t7 = jax.ShapeDtypeStruct((7,), jnp.float32)
    # Shapes of verify's per-candidate outputs feed close_loop_update
    # (close_loop takes one candidate's row: drop the batch dim).
    _, _, _, midx, mok = jax.eval_shape(
        verify_loops_batch, cfg, ms, ids, ids, keys
    )
    midx0 = jax.ShapeDtypeStruct(midx.shape[1:], midx.dtype)
    mok0 = jax.ShapeDtypeStruct(mok.shape[1:], mok.dtype)
    jobs = [
        ("train_vocab", lambda: train_vocab.lower(cfg, ls, ms).compile()),
        (
            "verify_loops",
            lambda: verify_loops_batch.lower(
                cfg, ms, ids, ids, keys
            ).compile(),
        ),
        (
            "close_loop",
            lambda: close_loop_update.lower(
                cfg, ms, i32, i32, t7, midx0, mok0, t7, i32
            ).compile(),
        ),
    ]
    if include_batch:
        cam = cfg.camera
        imgs = jax.ShapeDtypeStruct((BATCH, cam.height, cam.width), jnp.uint8)
        d16s = jax.ShapeDtypeStruct((BATCH,) + cam.depth_wire_shape,
                                    jnp.uint16)
        jobs.append((
            "fused_scan",
            lambda: slam_mod._fused_frame_scan.lower(
                cfg, ms, ls, tr, key, imgs, d16s, True
            ).compile(),
        ))
    times = {}

    def work(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            times[name] = round(time.perf_counter() - t0, 1)
        except Exception as e:  # AOT failure = in-path compile goes cold
            times[name] = -1.0
            print(f"[bench] AOT {name} failed: {e!r}", file=sys.stderr)

    threads = [
        threading.Thread(target=work, args=j, daemon=True) for j in jobs
    ]
    for t in threads:
        t.start()
    return _AotPrecompiles(threads, times)


def _precompile_host_events(slam):
    """Compile the rare host-event programs on the warmup engine's state so
    the measured passes never hit a compile: vocabulary (re)train, batched
    loop verification, and the fused loop-closure correction.  The compile
    set is shape-bound (cfg-static), so dummy indices compile the exact
    programs the real events run."""
    import jax
    import jax.numpy as jnp

    from boslam_tpu.loopclosure import train_vocab, verify_loops_batch
    from boslam_tpu.slam import SlamSystem
    from boslam_tpu.solvers.pose_graph import close_loop_update

    cfg = slam.cfg
    if slam._vocab_trained_at < 0:
        slam.loop = train_vocab(cfg, slam.loop, slam.map)
    kf = jnp.argmax(jnp.where(slam.map.kf_valid, slam.map.kf_seq, -1)).astype(
        jnp.int32
    )
    m = SlamSystem.MAX_VERIFY
    kf_ids = jnp.full((m,), kf, jnp.int32)
    keys = jax.random.split(jax.random.key(1), m)
    ok, t_rel, n_inl, midx, mok = verify_loops_batch(
        cfg, slam.map, kf_ids, jnp.zeros_like(kf_ids), keys
    )
    st2, _ = close_loop_update(
        cfg, slam.map, kf, jnp.zeros((), jnp.int32), t_rel[0], midx[0], mok[0],
        slam.track.pose_cw, slam.track.last_kf,
    )
    jax.block_until_ready(st2.kf_pose)


def _tracking_cfg(args):
    from boslam_tpu.config import (
        CameraConfig, LoopConfig, SlamConfig, TrackerConfig,
    )

    # Wide-FOV VGA RGBD camera (Kinect-FOV class) with fr2-range depth:
    # the hall-scale clover needs ~90 degrees of FOV to keep pixel flow
    # inside the matcher windows at a real frame rate — the narrow TUM fr1
    # intrinsics at this trajectory speed exceed their pixel-velocity
    # envelope 4x over.  All compute shapes (640x480, 512 features, 8
    # levels) are identical to the TUM presets, so the fps is the
    # production number.
    cam = CameraConfig(
        fx=260.0, fy=260.0, cx=319.5, cy=239.5, depth_max=20.0,
        depth_wire_stride=args.depth_stride,
    )
    return SlamConfig(
        camera=cam,
        loop=LoopConfig(min_gap_kf=8, consistency=2),
        tracker=TrackerConfig(kf_min_interval=2, kf_tracked_ratio=0.8),
    )


def bench_tracking(args, budget, rf, traj):
    cfg = rf.cfg

    # Warmup: the first fed frame compiles the fused step; the rare
    # host-event programs (vocab / verify / close-loop) and the batch scan
    # AOT-compile on worker threads in parallel with the remaining warmup
    # frames; _precompile_host_events then retraces them against the live
    # engine state, hitting the persistent cache the threads primed.
    t0 = time.perf_counter()
    warm = min(args.warmup_frames, args.frames)
    from boslam_tpu.slam import SlamSystem

    wt = {}
    include_batch = args.budget >= 240
    aot = _start_aot_precompiles(cfg, include_batch=include_batch)
    slam = SlamSystem(cfg)
    slam.feed(*rf.get(0))
    slam.flush()
    wt["first_frame_s"] = round(time.perf_counter() - t0, 1)
    t1 = time.perf_counter()
    for i in range(1, warm):
        slam.feed(*rf.get(i))
    slam.flush()
    wt["warm_frames_s"] = round(time.perf_counter() - t1, 1)
    t1 = time.perf_counter()
    aot.join(timeout_s=max(budget.remaining() - 60.0, 10.0))
    wt["aot_wait_s"] = round(time.perf_counter() - t1, 1)
    wt.update({f"aot_{k}_s": v for k, v in aot.times.items()})
    t1 = time.perf_counter()
    _precompile_host_events(slam)
    wt["host_events_s"] = round(time.perf_counter() - t1, 1)
    if include_batch and budget.remaining() > 0:
        t1 = time.perf_counter()
        lo = warm if warm + BATCH <= rf.n_total else 0
        slam.feed_batch([rf.get(lo + i) for i in range(BATCH)])
        slam.flush()
        wt["feed_batch_s"] = round(time.perf_counter() - t1, 1)
    else:
        include_batch = False
    wt["total_s"] = round(time.perf_counter() - t0, 1)
    print(
        f"[bench] warmup ({warm} frames, threaded AOT precompiles): "
        + " ".join(f"{k}={v}" for k, v in wt.items()),
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    frames = rf.wait_main()
    if time.perf_counter() - t0 > 0.5:
        print(
            f"[bench] waited {time.perf_counter()-t0:.1f}s for renderer",
            file=sys.stderr,
        )

    # Measured passes: fresh engine state, cached executables.  Up to
    # three passes, median reported (best kept as fps_best): one pass
    # carries the run-to-run spread of the host, and best-of-N would
    # inflate the headline.
    fps_runs = []
    for i in range(3):
        if i > 0 and budget.remaining() < 60:
            budget.skipped.append(f"fps_pass_{i}")
            break
        t0 = time.perf_counter()
        slam = _run_engine(cfg, frames)
        fps_runs.append(len(frames) / (time.perf_counter() - t0))
    fps = float(np.median(fps_runs))

    # Batch-feed throughput (offline/dataset mode): identical tracking on
    # identical frames, but one stacked H2D transfer + one scanned
    # dispatch per 16 frames instead of one of each per frame.
    from boslam_tpu.slam import run_sequence

    fps_batch_runs = []
    for i in range(2):
        # Needs the scan executable from warmup; first pass needs generous
        # headroom (the later phases matter more); the second runs only if
        # the first was competitive.
        if not include_batch or budget.remaining() < (
            150 if i == 0 else 60
        ) or (i == 1 and fps_batch_runs[0] < 0.9 * fps):
            budget.skipped.append(f"fps_batch_pass_{i}")
            break
        t0 = time.perf_counter()
        slam_b = run_sequence(cfg, frames, batch=BATCH)
        fps_batch_runs.append(len(frames) / (time.perf_counter() - t0))
    fps_batch = float(np.median(fps_batch_runs)) if fps_batch_runs else 0.0
    if fps_batch_runs and fps_batch >= fps:
        slam = slam_b  # same trajectory (equivalence-tested); freshest state

    rmse = _ate(slam, traj)
    n_lost = sum(1 for m in slam.metrics if m.get("lost", False))
    n_kf_events = sum(1 for m in slam.metrics if m.get("event") == "keyframe")
    print(
        f"[bench] fps={fps:.2f} (runs {[round(f,1) for f in fps_runs]}) "
        f"ate_rmse={rmse:.4f}m kf={slam.n_keyframes} (events={n_kf_events}) "
        f"pts={slam.n_points} lost={n_lost} loops={slam.n_loops_closed}",
        file=sys.stderr,
    )
    extras = {
        # Headline: best of stream-median and batch-median — both are full
        # tracking over the same frames (equivalence-tested); the mode
        # field says which won.
        "fps": round(max(fps, fps_batch), 3),
        "fps_mode": "batch" if fps_batch > fps else "stream",
        "fps_stream": round(fps, 3),
        "fps_batch": round(fps_batch, 3),
        "fps_best": round(max(fps_runs), 3),
        "fps_runs": [round(f, 2) for f in fps_runs],
        "fps_batch_runs": [round(f, 2) for f in fps_batch_runs],
        "ate_rmse_m": round(rmse, 5),
        "keyframes": int(slam.n_keyframes),
        "map_points": int(slam.n_points),
        "loops_closed": int(slam.n_loops_closed),
        "loop_edges": int(slam.map.n_loop_edges),
        "lost_frames": n_lost,
        "depth_wire_stride": cfg.camera.depth_wire_stride,
        **{f"warmup_{k}": v for k, v in wt.items()},
    }

    # Device-path ceiling + MFU belong in the PRIMARY line (VERDICT r4
    # item 3): the wall fps above additionally pays host work and
    # transfers; device_step_ms is the device's own cost per frame, and
    # step_util_* grounds it in hardware.
    if budget.allow("device_path"):
        with budget.timed("device_path"):
            from boslam_tpu.utils.timing import (
                fused_step_device_ms, fused_step_utilization,
            )

            _, gray, d16 = frames[len(frames) // 2]
            dev_ms = fused_step_device_ms(
                slam, gray, np.asarray(d16), scan_len=16
            )
            extras["device_step_ms"] = round(dev_ms, 2)
            extras["device_fps"] = round(1e3 / max(dev_ms, 1e-6), 1)
            extras.update(
                fused_step_utilization(slam, gray, np.asarray(d16), dev_ms)
            )
    return extras, slam, frames


def bench_stages(args, slam, frames, extras=None):
    """Per-stage ms + utilization (+ the device-path fps ceiling when the
    primary line didn't already measure it)."""
    from boslam_tpu.utils.timing import fused_step_device_ms, stage_timings

    cfg = slam.cfg
    _, gray, d16 = frames[len(frames) // 2]
    depth = np.asarray(d16).astype(np.float32) / cfg.camera.depth_factor
    stages = stage_timings(slam, gray.astype(np.float32), depth)
    if extras is None or "device_step_ms" not in extras:
        # Device-path ceiling: the fused step scan-chained on device, i.e.
        # the device's own cost per frame without host work or transfers.
        dev_ms = fused_step_device_ms(slam, gray, np.asarray(d16))
        stages["device_step_ms"] = dev_ms
        stages["device_fps"] = 1e3 / max(dev_ms, 1e-6)
    print("[bench] stages: " + " ".join(
        f"{k}={v:.4f}" if "util" in k else f"{k}={v:.2f}"
        for k, v in stages.items()), file=sys.stderr)
    return {
        k: round(v, 4 if "util" in k else 2) for k, v in stages.items()
    }


def bench_error_budget_cheap(args, budget, rf, traj, cfg, frames):
    """Cheap error-budget subset (VERDICT r3 item 4) — no recompiles:
    loop-off on the main render (drift floor) and the noise-0 render
    (intrinsic accuracy, same stride).  The full stride sweep (which
    recompiles the frame step per stride) is ``--error-budget``."""
    out = {}
    t0 = time.perf_counter()
    slam_off = _run_engine(cfg, frames, loop_off=True)
    out["ate_loop_off_m"] = round(_ate(slam_off, traj), 5)
    noise0 = rf.wait_extra("noise0", timeout_s=max(budget.remaining(), 5.0))
    if noise0 is not None:
        slam0 = _run_engine(cfg, noise0)
        out["ate_noise0_m"] = round(_ate(slam0, traj), 5)
        out["loops_noise0"] = int(slam0.n_loops_closed)
    else:
        budget.skipped.append("error_budget_noise0")
    print(
        f"[bench] error budget ({time.perf_counter()-t0:.1f}s): "
        + " ".join(f"{k}={v}" for k, v in out.items()), file=sys.stderr,
    )
    return out


def bench_error_budget_full(args, budget, traj):
    """Full 5-point error budget (VERDICT r3 item 4): ATE on noise-0 and
    2.5%-noise renders at stride 1 and 2, plus loop-off — separates
    intrinsic drift, the sensor-noise floor, the wire-format cost, and the
    loop-closure benefit.  Stride changes the wire shape, so each stride
    compiles its own frame step — run via ``--error-budget`` (too slow for
    the driver window cold)."""
    from boslam_tpu.io.synthetic import render_frame

    # Render each noise level ONCE at full resolution; the stride is a
    # wire-format transform applied afterwards.
    raw = {}
    cfg_any = _tracking_cfg(args)
    for noise, tag in ((0.0, "noise0"), (0.025, "noise25")):
        rng = np.random.default_rng(3)
        seq = []
        for ts, pose in zip(traj.timestamps, traj.poses_twc):
            rgb, depth = render_frame(cfg_any.camera, pose, room_scale=2.5)
            if noise > 0:
                depth = depth + rng.normal(size=depth.shape).astype(
                    np.float32
                ) * (noise * depth)
            seq.append((float(ts), rgb, depth))
        raw[tag] = seq
        print(f"[bench] error-budget: rendered {tag}", file=sys.stderr)

    out = {}
    for stride in (1, 2):
        a2 = argparse.Namespace(**vars(args))
        a2.depth_stride = stride
        cfg = _tracking_cfg(a2)
        for tag in ("noise0", "noise25"):
            frames = [_wire(cfg, *f) for f in raw[tag]]
            slam = _run_engine(cfg, frames)  # compile (per stride) + run
            t0 = time.perf_counter()
            slam = _run_engine(cfg, frames)
            dt = time.perf_counter() - t0
            key = f"ate_{tag}_stride{stride}_m"
            out[key] = round(_ate(slam, traj), 5)
            out[f"loops_{tag}_stride{stride}"] = int(slam.n_loops_closed)
            if tag == "noise25":
                slam_off = _run_engine(cfg, frames, loop_off=True)
                out[f"ate_loopoff_stride{stride}_m"] = round(
                    _ate(slam_off, traj), 5
                )
            print(
                f"[bench] error-budget stride={stride} {tag}: "
                f"ate={out[key]} loops={out[f'loops_{tag}_stride{stride}']} "
                f"({len(frames)/dt:.1f} fps)",
                file=sys.stderr,
            )
    print("[bench] error budget full: " + json.dumps(out), file=sys.stderr)
    return out


def bench_tracked_global_ba(args, budget, rf):
    """BASELINE config 4 on a map the ENGINE built (VERDICT r2 item 3):
    drive tracking over a survey trajectory to a large live map, then
    global-BA that state and measure LM iters/s + ATE before/after."""
    from boslam_tpu.config import (
        CameraConfig, LoopConfig, MapConfig, OrbConfig, SlamConfig,
        TrackerConfig,
    )
    from boslam_tpu.io import synthetic
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    # Same wide-FOV VGA camera as the tracking bench (see note there);
    # depth range covers the 3x-scale hall.
    cam = CameraConfig(fx=260.0, fy=260.0, cx=319.5, cy=239.5, depth_max=30.0)
    cfg = SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1024),
        # Dense-mapping configuration: a keyframe at least every 6 frames
        # and NO redundancy culling (kf_cull_redundancy > 1), so the survey
        # drives the map to config-4 scale — a smooth synthetic survey is
        # exactly the input the reference's 90%-redundancy cull was built
        # to collapse, and here map SCALE is the benchmark's subject.
        map=MapConfig(max_keyframes=256, max_points=65536,
                      kf_cull_redundancy=2.0),
        loop=LoopConfig(min_gap_kf=8, consistency=2),
        tracker=TrackerConfig(kf_min_interval=2, kf_max_interval=6,
                              kf_tracked_ratio=0.8),
    )
    traj = synthetic.survey_trajectory(args.ba_frames, span=6.0)
    frames = rf.wait_extra("survey", timeout_s=max(budget.remaining(), 10.0))
    if frames is None:
        budget.skipped.append("tracked_ba_render")
        return {}
    t0 = time.perf_counter()
    slam = _run_engine(cfg, frames)
    print(
        f"[bench] tracked-BA: engine run {time.perf_counter()-t0:.1f}s "
        f"(incl. compiles) kf={slam.n_keyframes} pts={slam.n_points}",
        file=sys.stderr,
    )
    ate_before = _ate(slam, traj)

    lm_iters = cfg.loop.global_ba_iters
    run = lambda st: global_bundle_adjustment(
        cfg, st, lm_iters=lm_iters, cg_iters=cfg.loop.global_ba_cg_iters
    )
    st2, stats = run(slam.map)          # compile + settle
    np.asarray(st2.kf_pose)             # value read = real sync
    # Salt the timed input so a cached (program, inputs) result can't
    # short-circuit the measurement; median of 2 reps.
    dts = []
    for i in range(2):
        salted = slam.map._replace(
            kf_pose=slam.map.kf_pose + 1e-30 * (i + 1)
        )
        t0 = time.perf_counter()
        st2, stats = run(salted)
        np.asarray(st2.kf_pose)
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    slam.map = st2
    ate_after = _ate(slam, traj)
    out = {
        "tba_keyframes": int(slam.n_keyframes),
        "tba_points": int(slam.n_points),
        "tba_edges": int(stats.n_edges),
        "tba_iters_per_sec": round(lm_iters / dt, 3),
        "tba_cost_reduction": round(
            float(stats.cost0 / max(float(stats.cost1), 1e-9)), 2
        ),
        "tba_ate_before_m": round(ate_before, 5),
        "tba_ate_after_m": round(ate_after, 5),
        "tba_loops_closed": int(slam.n_loops_closed),
    }
    print(
        f"[bench] tracked-BA: {out['tba_edges']} edges over "
        f"{out['tba_keyframes']} kf / {out['tba_points']} pts, "
        f"{out['tba_iters_per_sec']} LM iters/s, ATE {ate_before:.4f} -> "
        f"{ate_after:.4f} m", file=sys.stderr,
    )
    return out


def bench_global_ba(args):
    """BASELINE config-4 kernel scale: 50k landmarks, 131k observations."""
    import jax.numpy as jnp

    from boslam_tpu.config import MapConfig, OrbConfig, SlamConfig
    from boslam_tpu.io.synthetic import synthetic_ba_problem
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    cfg = SlamConfig(
        map=MapConfig(max_keyframes=256, max_points=65536),
        orb=OrbConfig(n_features=512),
    )
    rng = np.random.default_rng(0)
    st, gt_poses, _ = synthetic_ba_problem(
        cfg, rng, n_kf=256, n_pts=args.ba_points, obs_per_kf=512
    )
    lm_iters = 6
    run = lambda s: global_bundle_adjustment(cfg, s, lm_iters=lm_iters,
                                             cg_iters=40)
    st2, stats = run(st)
    np.asarray(st2.kf_pose)  # compile + settle (value read = real sync)
    # Median of 3 salted reps.
    dts = []
    for i in range(3):
        t0 = time.perf_counter()
        st2, stats = run(st._replace(kf_pose=st.kf_pose + 1e-30 * (i + 1)))
        np.asarray(st2.kf_pose)
        dts.append(time.perf_counter() - t0)
    iters_per_s = lm_iters / float(np.median(dts))
    from boslam_tpu.geometry import se3

    _, terr = se3.pose_distance(st2.kf_pose[:256], gt_poses)
    print(
        f"[bench] global BA: {int(stats.n_edges)} edges, "
        f"{int(jnp.sum(st.pt_valid))} pts, cost {float(stats.cost0):.0f}->"
        f"{float(stats.cost1):.0f}, {iters_per_s:.2f} LM iters/s, "
        f"max pose err {float(jnp.max(terr))*1e3:.1f}mm", file=sys.stderr,
    )
    return {
        "ba_iters_per_sec": round(iters_per_s, 3),
        "ba_landmarks": int(jnp.sum(st.pt_valid)),
        "ba_edges": int(stats.n_edges),
        "ba_cost_reduction": round(float(stats.cost0 / max(stats.cost1, 1e-9)), 1),
    }


def _device_record():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _emit(extras, budget=None):
    line = {
        "metric": "tracked_frames_per_sec_per_chip",
        "value": extras["fps"],
        "unit": "fps",
        # Denominator = 30 fps ORB-SLAM-family CPU rate; reference
        # itself unmeasured (mount empty) => this is a LOWER bound.
        "vs_baseline": round(extras["fps"] / BASELINE_FPS, 3),
        "baseline_note": "reference unmeasured (empty mount); "
                         "denominator=30fps ORB-SLAM-family CPU rate",
        "device": _device_record(),
        **extras,
    }
    if "device_fps" in extras:
        # The wall fps pays host work and transfers on top of the device
        # path.  Both ratios shown.
        line["vs_baseline_device"] = round(
            extras["device_fps"] / BASELINE_FPS, 3
        )
    if budget is not None:
        line["phases_skipped"] = budget.skipped
        line["elapsed_s"] = round(time.perf_counter() - budget.t0, 1)
    print(json.dumps(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=450)
    ap.add_argument("--warmup-frames", type=int, default=128)
    ap.add_argument("--ba-frames", type=int, default=400)
    ap.add_argument("--ba-points", type=int, default=50000)
    ap.add_argument("--budget", type=float, default=900.0,
                    help="wall-clock budget (s); later phases are skipped "
                         "once it is spent")
    ap.add_argument("--cpu", action="store_true", help="force CPU (debug)")
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--no-global-ba", action="store_true")
    ap.add_argument("--no-tracked-ba", action="store_true")
    ap.add_argument("--error-budget", action="store_true",
                    help="run the FULL stride/noise accuracy sweep instead "
                         "of the tracking benchmark (slow: recompiles per "
                         "stride; intended for manual runs)")
    # Depth ships at stride 2 by default: depth is only ever sampled at
    # keypoint pixels, so the full 614 KB u16 map per frame moves bytes
    # nothing reads.  The wire reduction is boundary-aware (medoid of each
    # 2x2 block, never mixing surfaces — slam.depth_wire), closing the
    # ~0.1 m ATE gap strided subsampling had (VERDICT r3 item 2).
    ap.add_argument("--depth-stride", type=int, default=2)
    args = ap.parse_args()

    budget = Budget(args.budget)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    print(f"[bench] device: {_device_record()}", file=sys.stderr)

    from boslam_tpu.io import synthetic

    traj = synthetic.clover_trajectory(
        args.frames, n_petals=3, radius=2.5, yaw_amplitude=0.4
    )

    if args.error_budget:
        out = bench_error_budget_full(args, budget, traj)
        out["fps"] = 0.0
        _emit(out, budget)
        return

    cfg = _tracking_cfg(args)
    rf = RenderFeed(cfg, traj, depth_noise=0.025, seed=3, room_scale=2.5)
    # Queue the extra renders now: they run on the render thread after the
    # main sequence, overlapped with device warmup/passes.
    rf.queue("noise0", cfg, traj, depth_noise=0.0, seed=3, room_scale=2.5)
    if not args.no_tracked_ba:
        from boslam_tpu.config import CameraConfig

        tba_cam = CameraConfig(
            fx=260.0, fy=260.0, cx=319.5, cy=239.5, depth_max=30.0
        )
        rf.queue(
            "survey", cfg.replace(camera=tba_cam),
            synthetic.survey_trajectory(args.ba_frames, span=6.0),
            depth_noise=0.01, seed=5, room_scale=3.0,
        )

    extras, slam, frames = bench_tracking(args, budget, rf, traj)
    # PRIMARY line: prints even if a later phase busts the driver window.
    _emit(extras)

    # Phase order = evidence priority: the BASELINE BA-iters/s primary
    # metric, then the accuracy error budget, then substage detail, then
    # the tracked-map BA.
    fps_est = max(extras.get("fps_stream", 10.0), 1.0)
    # BA iters/s is a BASELINE.json primary metric — it runs before the
    # error budget so a tight window still records it.
    if not args.no_global_ba and budget.allow("global_ba_50k"):
        with budget.timed("global_ba_50k"):
            extras.update(bench_global_ba(args))
    # 2 engine passes at the measured stream rate; x3 covers the spread
    # between the measured passes and these, plus the render wait.
    if budget.allow("error_budget_cheap", 6 * args.frames / fps_est + 25):
        with budget.timed("error_budget_cheap"):
            extras.update(
                bench_error_budget_cheap(args, budget, rf, traj, cfg, frames)
            )
    if not args.no_stages and budget.allow("stages"):
        with budget.timed("stages"):
            extras.update(bench_stages(args, slam, frames, extras))
    if not args.no_tracked_ba and budget.allow("tracked_ba"):
        with budget.timed("tracked_ba"):
            extras.update(bench_tracked_global_ba(args, budget, rf))
    extras["phase_times"] = budget.phase_times

    # FINAL line: strict superset of the primary line (drivers that parse
    # the last JSON line get everything; ones that parse the first still
    # get the primary metrics).
    _emit(extras, budget)


if __name__ == "__main__":
    main()
