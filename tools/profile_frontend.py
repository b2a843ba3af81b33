"""Device time of the frontend's substages and of the whole-map match.

Times what XLA makes of the plain jnp code at production shapes (640x480,
512 features, 8 levels): the whole ``extract_features`` call, then its
substages as standalone jitted programs — pyramid, blur, the FAST-9 rank
maps, grid selection, the patch gather, orientation + BRIEF, sub-pixel
refinement — and the tracker's whole-map match (``global_match``) at
several map sizes.

Per program: ``host_ms`` is the host-clock time per call over ``--reps``
back-to-back calls ended by one ``block_until_ready`` (launch overhead
included); ``device_ms`` is the device's busy time per call, the union of
the kernel intervals on the GPU's stream lines of a ``jax.profiler``
trace of the same calls ("not measured" without a GPU).  A substage's
share is its standalone device time over the whole call's, so fusion
across substage boundaries is not counted.

    python tools/profile_frontend.py [--reps 50]

Traces go to ``out/profile_frontend/<program>/``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
import sys

import numpy as np
import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from boslam_tpu.config import MapConfig, SlamConfig  # noqa: E402
from boslam_tpu.features import frontend as fe  # noqa: E402
from boslam_tpu.io import synthetic  # noqa: E402
from boslam_tpu.mapping import empty_map  # noqa: E402
from boslam_tpu.tracking.tracker import global_match  # noqa: E402

MATCH_SIZES = (16384, 32768, 131072)
TRACE_ROOT = ROOT / "out" / "profile_frontend"


def device_busy_ns(trace_dir: Path):
    """Union of kernel intervals on the GPU planes' stream lines of the
    newest trace in ``trace_dir``; None when the trace has no GPU plane."""
    from jax.profiler import ProfileData

    path = sorted(trace_dir.glob("plugins/profile/*/*.xplane.pb"))[-1]
    spans = []
    for plane in ProfileData.from_file(str(path)).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.start_ns + e.duration_ns)
                          for e in line.events]
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo


def timed(name, fn, *args, reps: int) -> dict:
    """host_ms and device_ms per call of jitted ``fn`` after a warm-up."""
    jitted = jax.jit(fn)
    jax.block_until_ready(jitted(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jitted(*args)
    jax.block_until_ready(out)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    trace_dir = TRACE_ROOT / name
    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.profiler.start_trace(str(trace_dir))
    for _ in range(reps):
        out = jitted(*args)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    busy = device_busy_ns(trace_dir)
    return {"host_ms": host_ms,
            "device_ms": None if busy is None else busy / 1e6 / reps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    reps = ap.parse_args().reps
    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind!r}",
          flush=True)

    cfg = SlamConfig()
    cam, orb = cfg.camera, cfg.orb
    rgb, depth = synthetic.render_frame(
        cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    gray = jnp.asarray(fe.rgb_to_gray(rgb))
    depth = jnp.asarray(depth)
    shapes = fe.pyramid_shapes(cam.height, cam.width, orb.n_levels,
                               orb.scale_factor)
    budgets = fe.distribute_features(orb.n_features, orb.n_levels,
                                     orb.scale_factor)
    kernel = jnp.asarray(fe._gauss7())
    t_hi, t_lo = float(orb.fast_threshold), float(orb.fast_threshold_min)

    def pyr(g):
        out, level = [], g
        for l, (hl, wl) in enumerate(shapes):
            if l > 0:
                level = jax.image.resize(level, (hl, wl), "linear")
            out.append(level)
        return tuple(out)

    levels = jax.jit(pyr)(gray)
    rng = np.random.default_rng(0)
    coords = []
    for l, (hl, wl) in enumerate(shapes):
        coords.append((
            jnp.asarray(rng.integers(17, hl - 17, budgets[l]), jnp.int32),
            jnp.asarray(rng.integers(17, wl - 17, budgets[l]), jnp.int32),
        ))
    patches = jnp.concatenate(
        [fe._extract_patches_jnp(levels[l], *coords[l])
         for l in range(orb.n_levels)])

    out = {"device_kind": dev.device_kind, "reps": reps}
    out["extract_features"] = timed(
        "extract_features", lambda g, d: fe.extract_features(g, d, cfg),
        gray, depth, reps=reps)
    whole = out["extract_features"]["device_ms"]
    stages = {
        "pyramid": (pyr, (gray,)),
        "blur": (lambda *ims: tuple(fe._blur(im, kernel) for im in ims),
                 levels),
        "fast_rank_maps": (
            lambda *ims: tuple(fe._fast_rank_maps(im, t_hi, t_lo, 17)
                               for im in ims), levels),
        "grid_select": (
            lambda *ims: tuple(fe._grid_select(im, budgets[l], orb.grid_rows,
                                               orb.grid_cols)
                               for l, im in enumerate(ims)), levels),
        "patch_gather": (
            lambda *ims: tuple(fe._extract_patches_jnp(im, *coords[l])
                               for l, im in enumerate(ims)), levels),
        "orient_and_brief": (fe.orient_and_brief, (patches,)),
        "subpixel": (
            lambda *ims: tuple(fe._subpixel_offsets(im, *coords[l])
                               for l, im in enumerate(ims)), levels),
    }
    for name, (fn, args) in stages.items():
        r = timed(name, fn, *args, reps=reps)
        if whole and r["device_ms"] is not None:
            r["share"] = r["device_ms"] / whole
        out[name] = r

    feats = fe.extract_features(gray, depth, cfg)
    for p in MATCH_SIZES:
        cfg_p = cfg.replace(map=MapConfig(max_points=p))
        desc = rng.integers(0, 2**32, (p, 8), dtype=np.uint32)
        st = empty_map(cfg_p)._replace(
            pt_desc=jnp.asarray(desc), pt_valid=jnp.ones((p,), bool))
        out[f"global_match_{p}"] = timed(
            f"global_match_{p}", lambda f, s, c=cfg_p: global_match(c, f, s),
            feats, st, reps=reps)
    for k, v in out.items():
        if isinstance(v, dict):
            v = " ".join(
                f"{kk}={'not measured' if vv is None else f'{vv:.4f}'}"
                for kk, vv in v.items())
        print(f"  {k:20s} {v}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
