"""Per-stage timing harness (SURVEY.md §5.1).

Times each pipeline stage on PRODUCTION shapes against live engine state —
feature extraction, frame-to-map tracking (matching + motion-only BA), local
bundle adjustment, and the fused whole-frame step — so optimization work is
measured, not guessed.  Each stage runs as a scan chain with full-sum data
dependence and salted inputs, synced by a value read, and the reported
number is the difference between scan lengths N and 2N, so constant
per-call overhead (dispatch, readback) cancels.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np


# Peak rates per device kind (as ``jax.devices()[0].device_kind`` reports
# it): (dense bf16 FLOP/s, device-memory bytes/s).  Source: NVIDIA's H100
# data sheet, SXM part, at its full 700 W power limit; a card set to a lower
# limit cannot hold these clocks, so report its power limit beside any
# fraction of these peaks.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def device_peaks():
    """(peak_flops_per_s, peak_bytes_per_s) of device 0.

    The host CPU has no roofline here: returns None for it, by design.  Any
    accelerator kind missing from the table raises — a utilization against
    a guessed peak is worse than none."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return None
    try:
        return _DEVICE_PEAKS[dev.device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {dev.device_kind!r}; add its "
            f"data-sheet row to utils.timing._DEVICE_PEAKS"
        ) from None


def _cost_analysis(lowerable, *args):
    """XLA-estimated (flops, bytes accessed) of a jitted fn at args."""
    try:
        c = lowerable.lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0]
        return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))
    except Exception:
        return None


def fused_step_device_ms(slam, gray_u8: np.ndarray, d16: np.ndarray,
                         scan_len: int = 32) -> float:
    """Device-path ms/frame of the FULL fused frame step, measured as a
    ``lax.scan`` chain with the engine state threaded through the carry.

    This is the engine's compute ceiling: what the device pays per frame,
    excluding host transfers and dispatch.  Value-read sync, salted
    input, and the reported number is the DIFFERENCE between scan lengths
    N and 2N so constant overhead cancels.
    """
    from boslam_tpu.slam import frame_step_core

    cfg = slam.cfg
    img = jnp.asarray(gray_u8)
    d16 = jnp.asarray(d16)

    def make(length):
        def chained(ms0, ls0, tr0, key0, salt):
            def body(carry, _):
                ms, ls, tr, key = carry
                ms, ls, tr, key, row = frame_step_core(
                    cfg, ms, ls, tr, key, img, d16)
                return (ms, ls, tr, key), row[8]

            _, outs = jax.lax.scan(
                body,
                (ms0, ls0,
                 tr0._replace(pose_cw=tr0.pose_cw + salt * 1e-30), key0),
                None, length=length)
            return jnp.sum(outs)

        return jax.jit(chained, donate_argnums=(0, 1, 2, 3))

    def run(jc, salt):
        ms = jax.tree.map(jnp.copy, slam.map)
        ls = jax.tree.map(jnp.copy, slam.loop)
        tr = jax.tree.map(jnp.copy, slam.track)
        return float(jc(ms, ls, tr, jnp.copy(slam.key), salt))

    walls = {}
    for length in (scan_len, 2 * scan_len):
        jc = make(length)
        run(jc, np.float32(0))  # compile + settle
        ts = []
        # 7 reps: the N-vs-2N difference of two medians is more sensitive
        # to one slow run than either median alone.
        for i in range(7):
            t0 = time.perf_counter()
            run(jc, np.float32(length * 131 + i + 1))
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[length] = float(np.median(ts))
    return (walls[2 * scan_len] - walls[scan_len]) / scan_len


def fused_step_utilization(slam, gray_u8: np.ndarray, d16: np.ndarray,
                           measured_ms: float) -> Dict[str, float]:
    """MFU-style utilization of the WHOLE fused frame step: XLA
    cost-analysis FLOPs / HBM bytes of the live engine's flagship program
    divided by the measured device ms and the chip's peak rates (VERDICT
    r4 item 3 — single-chip perf judged as utilization, not wall fps
    alone).  The ``.lower().compile()`` here resolves
    to the exact executable the engine runs (same shapes, same donation),
    so with the persistent cache warm it costs seconds."""
    from boslam_tpu.slam import _fused_frame_step

    peaks = device_peaks()
    if peaks is None or measured_ms <= 0:
        return {}
    try:
        c = _fused_step_cost(slam, gray_u8, d16)
    except Exception:
        return {}
    if c is None:
        return {}
    flops, nbytes = c
    sec = measured_ms * 1e-3
    peak_f, peak_b = peaks
    return {
        "step_gflops": round(flops / 1e9, 2),
        "step_util_flops": round(flops / sec / peak_f, 4),
        # Absolute effective byte rate, NOT a fraction of the memory peak:
        # XLA's "bytes accessed" counts every buffer touch including fused
        # intermediates that never reach device memory, so a ratio against
        # the peak can exceed 1 on well-fused programs and would misread as
        # impossible utilization.
        "step_bytes_gbps": round(nbytes / sec / 1e9, 1),
    }


def _fused_step_cost(slam, gray_u8, d16):
    from boslam_tpu.slam import _fused_frame_step

    c = _fused_frame_step.lower(
        slam.cfg, slam.map, slam.loop, slam.track, slam.key,
        jnp.asarray(gray_u8), jnp.asarray(d16), True,
    ).compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    if not c:
        return None
    return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))


def _scan_diff_ms(fn, captures, scan_len: int = 16, reps: int = 7) -> float:
    """ms per call of ``fn(eps, captures)`` measured as a scan chain with
    full-sum data dependence, salted input, value-read sync, and N-vs-2N
    length differencing, so per-call dispatch and readback cancel.

    ``captures`` (a pytree of arrays the stage reads: images, map state,
    ...) is passed as a jit ARGUMENT, not a closure: closed-over arrays
    embed as HLO constants, which keys the compiled program on the STATE
    VALUES — every bench run with a different warmup state would recompile
    all six stage programs from scratch."""
    import functools

    def body_of(caps):
        def body(acc, _):
            out = fn(acc * 1e-30, caps)
            return acc + sum(
                jnp.sum(l.astype(jnp.float32))
                for l in jax.tree_util.tree_leaves(out)
            ), None

        return body

    walls = {}
    for length in (scan_len, 2 * scan_len):
        jl = jax.jit(functools.partial(
            lambda salt, caps, _l: jax.lax.scan(
                body_of(caps), salt * 1e-30, None, length=_l)[0],
            _l=length))
        float(jl(np.float32(0), captures))  # compile + settle
        ts = []
        for i in range(reps):
            t0 = time.perf_counter()
            float(jl(np.float32(length * 131 + i + 1), captures))
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[length] = float(np.median(ts))
    return (walls[2 * scan_len] - walls[scan_len]) / scan_len


def stage_timings(slam, gray: np.ndarray, depth: np.ndarray,
                  repeats: int = 7) -> Dict[str, float]:
    """ms per pipeline stage using ``slam``'s live map/track state, plus
    utilization: XLA-estimated FLOPs and HBM bytes per stage divided by
    measured time and the chip's peak rates (VERDICT r2 item 8 — fps
    claims are utilization-grounded, not just wall-clock).  Measured with
    the scan-diff harness (see _scan_diff_ms), not a sync-per-call loop.

    Args:
      slam: a SlamSystem that has processed frames (map populated).
      gray: [H, W] f32 grayscale frame; depth: [H, W] f32 metres.
    """
    from boslam_tpu.features import extract_features
    from boslam_tpu.mapping.map_state import latest_kf_slot
    from boslam_tpu.solvers.local_ba import local_bundle_adjustment
    from boslam_tpu.tracking.tracker import track_frame

    cfg = slam.cfg
    g = jnp.asarray(gray)
    d = jnp.asarray(depth)
    feats = extract_features(g, d, cfg)
    jax.block_until_ready(feats.uv)
    center = latest_kf_slot(slam.map)
    ms_, tr_ = slam.map, slam.track

    stages = {
        "feature": (
            lambda eps, c: extract_features(c[0] + eps, c[1], cfg),
            (g, d),
            (extract_features, (g, d, cfg)),
        ),
        "track": (
            lambda eps, c: track_frame(
                cfg, c[0], c[1]._replace(pose_cw=c[1].pose_cw + eps), c[2]
            ),
            (ms_, tr_, feats),
            (track_frame, (cfg, ms_, tr_, feats)),
        ),
        "local_ba": (
            lambda eps, c: local_bundle_adjustment(
                cfg, c[0]._replace(kf_pose=c[0].kf_pose + eps), c[1]
            ),
            (ms_, center),
            (local_bundle_adjustment, (cfg, ms_, center)),
        ),
    }
    peaks = device_peaks()
    out = {}
    for name, (run, captures, (jitted, args)) in stages.items():
        ms = _scan_diff_ms(run, captures, reps=repeats)
        out[f"{name}_ms"] = ms
        cost = _cost_analysis(jitted, *args)
        if cost is not None and peaks is not None and ms > 0:
            flops, nbytes = cost
            peak_f, peak_b = peaks
            out[f"{name}_util_flops"] = flops / (ms * 1e-3) / peak_f
            out[f"{name}_util_hbm"] = nbytes / (ms * 1e-3) / peak_b
    return out
