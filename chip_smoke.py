"""Smoke run of the SLAM engine on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-device paths on four cards

One card: the phases below run in order, each prints one line, and any
failure raises, so the process exits non-zero without printing a result.

1. device: JAX's first device must be a GPU (no CPU fallback); prints the
   card's name and power limit, the JAX version and the compile cache.
2. parity: the GPU result of the Hamming matrix, the feature frontend and
   the tracker's whole-map match, each at the bench fixture's widths,
   against the same JAX code run on the host CPU in this process.
3. end to end: ``SlamSystem.feed``/``flush`` over the bench's main fixture
   (450-frame hall clover, 640x480, 512 features, 8 levels, 2.5 % depth
   noise, seed 3): no lost frame after init, local BA on keyframe events,
   at least one loop closure and ATE under ``ATE_BOUND_M``.
4. solver parity: one local BA and one global BA on the map step 3 built,
   GPU against the host CPU.
5. global BA through ``SlamSystem.run_global_ba`` on that map.
6. rerun: the same fixture again after clearing the in-memory jit caches
   (warm persistent-cache compile, steady frames/s, bit-identity).

``--four-cards`` runs only the two multi-device paths: the 50k-landmark /
131k-edge global BA sharded over 'pt', checked against single-card global
BA, and four unequal-length clover sequences data-parallel over a 'seq'
mesh, each checked against the same sequence run alone on card 0.

The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# The parity references run on the host CPU backend in this process, so a
# platform list that names only the GPU gets the CPU added back.
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402

# ATE bound of the one-card end-to-end run.  The same fixture and seed on
# the host CPU (XLA:CPU, f32) reach 0.1206 m with 1 loop closed at frame
# 291, and 0.1424 m after the exit global BA.  GPU arithmetic (TF32
# products, other reduction orders) shifts keyframe and loop timing, which
# moves ATE by centimetres, so the bound is 1.5x the CPU figure.  It does
# not by itself prove the loop closed; that is checked on its own.
ATE_BOUND_M = 0.18

HAMMING_N = 512
HAMMING_MS = (16384, 32768)
WHOLE_MAP_P = 32768


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Set-up shared by both modes.
# ---------------------------------------------------------------------------

def require_gpu(n_cards: int):
    """Fail before any work unless JAX's first device is a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's first device is "
            f"{devs[0].platform!r}"
        )
    check(len(devs) >= n_cards, f"needs {n_cards} GPUs, JAX sees {len(devs)}")
    return devs


def import_engine():
    """Import the engine from this checkout (never from elsewhere)."""
    import boslam_tpu

    here = Path(__file__).resolve().parent
    pkg_root = Path(boslam_tpu.__file__).resolve().parent.parent
    check(pkg_root == here, f"boslam_tpu imported from {pkg_root}, not {here}")
    return boslam_tpu


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return "; ".join(line.strip() for line in out.splitlines())


def phase_device(n_cards: int):
    devs = require_gpu(n_cards)
    import_engine()
    print(f"card: {card_line()}", flush=True)
    print(
        f"device: kind={devs[0].device_kind!r} count={len(devs)} "
        f"jax={jax.__version__} "
        f"compile_cache={jax.config.jax_compilation_cache_dir}",
        flush=True,
    )
    return devs


def fixture_cfg():
    """The bench's main tracking configuration (bench._tracking_cfg)."""
    import bench

    return bench._tracking_cfg(argparse.Namespace(depth_stride=2))


def clover(n_frames: int, radius: float = 2.5):
    from boslam_tpu.io import synthetic

    return synthetic.clover_trajectory(
        n_frames, n_petals=3, radius=radius, yaw_amplitude=0.4
    )


def render_wire(cfg, traj, depth_noise: float, seed: int,
                room_scale: float = 2.5):
    """Wire-format frames (ts, gray u8, depth u16), bit-identical to
    bench.RenderFeed: renders run on threads, the depth noise is drawn in
    frame order from one generator."""
    import bench
    from boslam_tpu.io.synthetic import render_frame

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        renders = list(ex.map(
            lambda pose: render_frame(cfg.camera, pose, room_scale=room_scale),
            traj.poses_twc,
        ))
    rng = np.random.default_rng(seed)
    frames = []
    for ts, (rgb, depth) in zip(traj.timestamps, renders):
        if depth_noise > 0:
            depth = depth + rng.normal(size=depth.shape).astype(
                np.float32
            ) * (depth_noise * depth)
        frames.append(bench._wire(cfg, float(ts), rgb, depth))
    return frames


def run_engine(cfg, frames):
    """Feed every frame through SlamSystem.feed/flush.  Returns (slam,
    first-frame seconds, steady frames/s over the rest)."""
    from boslam_tpu.slam import SlamSystem

    slam = SlamSystem(cfg)
    t0 = time.perf_counter()
    slam.feed(*frames[0])
    slam.flush()
    t1 = time.perf_counter()
    for f in frames[1:]:
        slam.feed(*f)
    slam.flush()
    jax.block_until_ready(slam.map.kf_pose)
    t2 = time.perf_counter()
    return slam, t1 - t0, (len(frames) - 1) / (t2 - t1)


def to(dev, tree):
    return jax.device_put(tree, dev)


def max_pose_delta(a, b, valid):
    """Largest camera-centre distance (m) between two [K, 7] T_cw arrays,
    which may live on different devices."""
    from boslam_tpu.geometry import se3

    _, dt = se3.pose_distance(*(jax.numpy.asarray(np.asarray(x))
                                for x in (a, b)))
    return float(np.max(np.where(np.asarray(valid), np.asarray(dt), 0.0)))


# ---------------------------------------------------------------------------
# One card.
# ---------------------------------------------------------------------------

def parity_hamming(gpu, cpu):
    from boslam_tpu.matching import hamming

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(HAMMING_N, 8), dtype=np.uint32)
    for m in HAMMING_MS:
        b = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
        b[: m // 8] = a[rng.integers(0, HAMMING_N, m // 8)]
        got = np.asarray(jax.jit(hamming.hamming_matrix_mxu)(
            to(gpu, a), to(gpu, b)))
        ref = np.asarray(jax.jit(hamming.hamming_matrix)(
            to(cpu, a), to(cpu, b)))
        check(np.array_equal(got, ref),
              f"hamming_matrix_mxu differs from popcount at M={m}: "
              f"{int(np.sum(got != ref))} entries")
        print(f"parity hamming N={HAMMING_N} M={m}: bf16 bit-matmul with f32 "
              f"accumulation on GPU == exact popcount on CPU (tolerance 0: "
              f"0/1 operands and sums <= 256 are exact in both)", flush=True)


def parity_frontend(cfg, frame, gpu, cpu):
    """Returns the GPU features (for the whole-map match check)."""
    from boslam_tpu.features import extract_features

    _, gray, d16 = frame
    gray = gray.astype(np.float32)
    depth = d16.astype(np.float32) * (1.0 / cfg.camera.depth_factor)
    fg = jax.tree.map(np.asarray, extract_features(
        to(gpu, gray), to(gpu, depth), cfg))
    fc = jax.tree.map(np.asarray, extract_features(
        to(cpu, gray), to(cpu, depth), cfg))
    both = fg.valid & fc.valid
    n_valid = int(fc.valid.sum())
    same_valid = float(np.mean(fg.valid == fc.valid))
    uv_err = np.max(np.abs(fg.uv - fc.uv)[both]) if both.any() else 0.0
    bits = np.unpackbits(
        (fg.desc ^ fc.desc).view(np.uint8), axis=-1
    ).sum(-1)[both]
    same_kp = float(np.mean(
        (np.max(np.abs(fg.uv - fc.uv), -1) <= 1e-3)[both] & (bits == 0)
    ))
    print(f"parity extract_features 640x480 512 feats 8 levels: "
          f"{n_valid} valid; valid mask agrees on {same_valid:.4f} of slots; "
          f"max uv diff {uv_err:.2e} px; keypoints with uv within 1e-3 px and "
          f"identical descriptor {same_kp:.4f}; mean descriptor bits "
          f"differing {bits.mean():.3f}/256 (precision: HIGHEST in the "
          f"orientation and BRIEF einsums, the pyramid resize and the rest "
          f"elementwise f32; tolerance: valid mask >= 0.99, uv <= 1e-2 px "
          f"on both-valid slots, >= 0.98 identical keypoints, mean <= 0.1 "
          f"bit: only f32 rounding differs, and a tie it moves can swap a "
          f"grid cell's pick or flip one BRIEF test)", flush=True)
    check(same_valid >= 0.99, f"frontend valid mask agrees on {same_valid}")
    check(uv_err <= 1e-2, f"frontend uv differs by {uv_err} px")
    check(same_kp >= 0.98, f"only {same_kp} of keypoints identical")
    check(bits.mean() <= 0.1, f"descriptors differ by {bits.mean()} bits")
    return fg


def parity_whole_map(cfg, feats, gpu, cpu):
    """tracker.global_match at P=32768 (relocalization before the
    vocabulary exists): GPU vs CPU, exact."""
    from boslam_tpu.config import MapConfig
    from boslam_tpu.mapping import empty_map
    from boslam_tpu.tracking.tracker import global_match

    cfg = cfg.replace(map=MapConfig(max_points=WHOLE_MAP_P))
    rng = np.random.default_rng(1)
    st = empty_map(cfg)
    desc = rng.integers(0, 2**32, size=(WHOLE_MAP_P, 8), dtype=np.uint32)
    n = feats.desc.shape[0]
    # A tenth of the map carries near-copies of the frame's descriptors.
    src = rng.integers(0, n, WHOLE_MAP_P // 10)
    flip = (rng.random((WHOLE_MAP_P // 10, 8, 32)) < 0.02)
    desc[: WHOLE_MAP_P // 10] = feats.desc[src] ^ np.packbits(
        flip, axis=-1, bitorder="little").view(np.uint32).reshape(-1, 8)
    angle = np.zeros(WHOLE_MAP_P, np.float32)
    angle[: WHOLE_MAP_P // 10] = feats.angle[src]
    st = st._replace(
        pt_desc=desc, pt_angle=angle,
        pt_valid=rng.random(WHOLE_MAP_P) < 0.95,
    )
    fn = jax.jit(global_match, static_argnums=0)
    ig, og = jax.tree.map(np.asarray, fn(cfg, to(gpu, feats), to(gpu, st)))
    ic, oc = jax.tree.map(np.asarray, fn(cfg, to(cpu, feats), to(cpu, st)))
    check(np.array_equal(ig, ic) and np.array_equal(og, oc),
          f"whole-map match differs: {int(np.sum(ig != ic))} indices")
    check(og.sum() > 0, "whole-map match found no matches")
    print(f"parity tracker.global_match P={WHOLE_MAP_P}: {int(og.sum())} "
          f"matches, GPU == CPU (tolerance 0: integer Hamming distances, "
          f"first-index argmin on both)", flush=True)


def phase_end_to_end(cfg, frames, traj):
    import bench

    slam, first_s, fps = run_engine(cfg, frames)
    ate = bench._ate(slam, traj)
    m = slam.metrics
    first_ok = next(i for i, r in enumerate(m) if r["status"] == 1)
    lost = sum(1 for r in m[first_ok:]
               if r["lost"] or r.get("event") == "relocalize")
    kf_ba = sum(1 for r in m
                if r.get("event") in ("keyframe", "loop_closed")
                and r.get("ba_edges", 0) > 0)
    print(f"end to end: {len(frames)} frames, cold first frame "
          f"{first_s:.1f} s (compile), steady {fps:.1f} frames/s, "
          f"{slam.n_keyframes} keyframes, {slam.n_points} points, "
          f"{kf_ba} keyframe events with local BA, {lost} lost frames, "
          f"{slam.n_loops_closed} loops closed, ATE {ate:.4f} m "
          f"(bound {ATE_BOUND_M} m)", flush=True)
    check(lost == 0, f"{lost} frames lost after initialisation")
    check(kf_ba >= 1, "no keyframe event ran local BA")
    check(slam.n_loops_closed >= 1, "no loop closed")
    check(ate <= ATE_BOUND_M, f"ATE {ate} m over {ATE_BOUND_M} m")
    return slam, ate


def parity_solvers(cfg, state, gpu, cpu):
    from boslam_tpu.mapping.map_state import latest_kf_slot
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment
    from boslam_tpu.solvers.local_ba import local_bundle_adjustment

    state = jax.tree.map(np.asarray, state)
    valid = state.kf_valid
    center = np.asarray(latest_kf_slot(to(cpu, state)))
    sg, lg = local_bundle_adjustment(cfg, to(gpu, state), to(gpu, center))
    sc, lc = local_bundle_adjustment(cfg, to(cpu, state), to(cpu, center))
    c1g, c1c = float(lg.cost1), float(lc.cost1)
    rel = abs(c1g - c1c) / max(c1c, 1e-9)
    dpose = max_pose_delta(sg.kf_pose, sc.kf_pose, valid)
    print(f"parity local_bundle_adjustment (keyframe {int(center)}, "
          f"{int(lc.n_edges)} edges): cost {float(lc.cost0):.2f} -> GPU "
          f"{c1g:.4f} / CPU {c1c:.4f} (rel {rel:.2e}), max pose delta "
          f"{dpose:.2e} m (HIGHEST precision in the normal equations; "
          f"tolerance rel cost <= 1e-3, pose <= 1e-4 m: f32 reduction order "
          f"only)", flush=True)
    check(rel <= 1e-3 and dpose <= 1e-4, "local BA GPU/CPU mismatch")

    it, cg = cfg.loop.global_ba_iters, cfg.loop.global_ba_cg_iters
    sg, gg = global_bundle_adjustment(cfg, to(gpu, state), it, cg)
    sc, gc = global_bundle_adjustment(cfg, to(cpu, state), it, cg)
    c0g, c0c = float(gg.cost0), float(gc.cost0)
    c1g, c1c = float(gg.cost1), float(gc.cost1)
    rel0 = abs(c0g - c0c) / max(c0c, 1e-9)
    rel = abs(c1g - c1c) / max(c1c, 1e-9)
    dpose = max_pose_delta(sg.kf_pose, sc.kf_pose, valid)
    print(f"parity global_bundle_adjustment ({int(gc.n_edges)} edges, "
          f"{it} LM x {cg} CG): cost {c0c:.2f} -> GPU {c1g:.4f} / CPU "
          f"{c1c:.4f} (cost0 rel {rel0:.2e}, cost1 rel {rel:.2e}), max pose "
          f"delta {dpose:.2e} m (default precision: its einsums contract "
          f"3- and 6-wide axes, which XLA:GPU fuses without TF32 matmuls; "
          f"tolerance cost0 rel <= 1e-4, cost1 rel <= 1e-2, pose <= 1e-3 m: "
          f"the PCG exits on a residual tolerance, so reduction order can "
          f"move its iteration count)", flush=True)
    check(rel0 <= 1e-4 and rel <= 1e-2 and dpose <= 1e-3,
          "global BA GPU/CPU mismatch")


def phase_global_ba(slam, traj, ate_before):
    import bench

    rec = slam.run_global_ba()
    ate = bench._ate(slam, traj)
    print(f"global BA (run_global_ba): {rec['gba_edges']} edges, cost "
          f"{rec['gba_cost0']:.1f} -> {rec['gba_cost1']:.1f}, ATE "
          f"{ate_before:.4f} -> {ate:.4f} m (not bounded: global BA on this "
          f"map raises ATE on the CPU too)", flush=True)
    check(np.isfinite(rec["gba_cost1"])
          and rec["gba_cost1"] <= rec["gba_cost0"], "global BA raised cost")
    check(np.isfinite(ate), "ATE after global BA is not finite")


def phase_rerun(cfg, frames, traj, poses1):
    import bench

    jax.clear_caches()
    slam, first_s, fps = run_engine(cfg, frames)
    _, poses2 = slam.trajectory()
    same = np.array_equal(poses1, poses2)
    diff = float(np.max(np.abs(poses1 - poses2)))
    ate = bench._ate(slam, traj)
    print(f"rerun: warm first frame {first_s:.1f} s (persistent cache), "
          f"steady {fps:.1f} frames/s, ATE {ate:.4f} m; trajectory "
          f"bit-identical to the first run: {same} (max |diff| {diff:.2e})",
          flush=True)
    check(ate <= ATE_BOUND_M and slam.n_loops_closed >= 1,
          f"rerun ATE {ate} m, {slam.n_loops_closed} loops")


def run_one_card() -> dict:
    devs = phase_device(1)
    gpu, cpu = devs[0], jax.devices("cpu")[0]
    cfg = fixture_cfg()
    traj = clover(450)
    t0 = time.perf_counter()
    frames = render_wire(cfg, traj, depth_noise=0.025, seed=3)
    print(f"fixture: {len(frames)} frames rendered on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    parity_hamming(gpu, cpu)
    feats = parity_frontend(cfg, frames[len(frames) // 2], gpu, cpu)
    parity_whole_map(cfg, feats, gpu, cpu)

    slam, ate = phase_end_to_end(cfg, frames, traj)
    _, poses1 = slam.trajectory()
    parity_solvers(cfg, slam.map, gpu, cpu)
    phase_global_ba(slam, traj, ate)
    phase_rerun(cfg, frames, traj, poses1)
    return {"platform": gpu.platform, "kind": gpu.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------------------
# Four cards.
# ---------------------------------------------------------------------------

DP_LENGTHS = (64, 56, 48, 40)
# Two runs of one sequence on one card agree bit for bit, but the
# multi-sequence program is compiled apart from the plain engine and rounds
# differently: on a one-device 'seq' mesh the 56- and 64-frame sequences
# ended 4.8e-5 and 9.4e-5 m from the plain engine on an H100.  1 cm leaves
# a hundredfold margin; a DP run fed the wrong frames or device is off by
# metres.  A rounding difference can move a keyframe decision, hence the
# keyframe-count margin.
DP_TOL_M = 0.01
DP_KF_TOL = 2


def run_single(cfg, frames, device):
    from boslam_tpu.slam import SlamSystem

    with jax.default_device(device):
        slam = SlamSystem(cfg)
        for f in frames:
            slam.feed(*f)
        slam.flush()
    return slam


def max_position_delta(a, b):
    return float(np.max(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=-1)))


def phase_dp(cfg, lengths, devices, render_seed: int = 3):
    from boslam_tpu.parallel.multi import run_sequences, seq_mesh

    frame_lists = []
    for s, n in enumerate(lengths):
        traj = clover(450, radius=2.5 - 0.25 * s)
        traj.poses_twc = traj.poses_twc[:n]
        traj.timestamps = traj.timestamps[:n]
        frame_lists.append(render_wire(cfg, traj, depth_noise=0.025,
                                       seed=render_seed + s))
    mesh = seq_mesh(len(lengths), devices)
    eng = run_sequences(cfg, frame_lists, mesh=mesh)
    shard_devs = {sh.device for sh in eng.map.kf_pose.addressable_shards}
    check(len(shard_devs) == len(lengths),
          f"'seq' shards sit on {len(shard_devs)} devices, not "
          f"{len(lengths)}")
    failures = []
    for s, frames in enumerate(frame_lists):
        single = run_single(cfg, frames, devices[0])
        _, est_a = single.trajectory()
        _, est_b = eng.trajectory(s)
        check(len(est_b) == len(frames), f"sequence {s} length mismatch")
        d = max_position_delta(est_b, est_a)
        kf_diff = abs(eng.n_keyframes(s) - single.n_keyframes)
        lost = sum(r["lost"] for r in eng.metrics[s])
        print(f"  sequence {s}: {len(frames)} frames, max position "
              f"difference DP vs single {d:.2e} m, keyframes DP "
              f"{eng.n_keyframes(s)} / single {single.n_keyframes}, "
              f"{lost} lost", flush=True)
        if d > DP_TOL_M or kf_diff > DP_KF_TOL or lost:
            failures.append(s)
    print(f"four cards, multi-sequence DP: {len(lengths)} clover sequences "
          f"of {list(lengths)} frames on {len(shard_devs)} devices; "
          f"sequences outside tolerance: {failures or 'none'} (positions "
          f"within {DP_TOL_M} m of card 0 alone, keyframe counts within "
          f"{DP_KF_TOL}, no lost frame)", flush=True)
    check(not failures, f"DP sequences {failures} disagree with single card")


def phase_sharded_gba(devices, n_pts: int = 50000, n_kf: int = 256):
    from boslam_tpu.config import MapConfig, OrbConfig, SlamConfig
    from boslam_tpu.io.synthetic import synthetic_ba_problem
    from boslam_tpu.parallel import make_mesh
    from boslam_tpu.parallel.sharded_global_ba import distributed_global_ba
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    # bench.bench_global_ba's problem.
    cfg = SlamConfig(map=MapConfig(max_keyframes=256, max_points=65536),
                     orb=OrbConfig(n_features=512))
    with jax.default_device(devices[0]):
        st, gt_poses, _ = synthetic_ba_problem(
            cfg, np.random.default_rng(0), n_kf=n_kf, n_pts=n_pts,
            obs_per_kf=512)
        s1, stats = global_bundle_adjustment(cfg, st, 6, 40)
    mesh = make_mesh(len(devices), seq=1, devices=devices)
    check(len({d.id for d in mesh.devices.flat}) == len(devices),
          "'pt' mesh repeats a device")
    s4, (c0, c1, n_edges) = distributed_global_ba(cfg, mesh, st, 6, 40)
    c1s = float(stats.cost1)
    rel = abs(c1 - c1s) / max(c1s, 1e-9)
    dpose = max_pose_delta(s1.kf_pose, s4.kf_pose, s1.kf_valid)
    gt = np.zeros_like(np.asarray(s1.kf_pose))
    gt[:n_kf] = gt_poses
    err1 = max_pose_delta(s1.kf_pose[:n_kf], gt[:n_kf], np.ones(n_kf, bool))
    err4 = max_pose_delta(s4.kf_pose[:n_kf], gt[:n_kf], np.ones(n_kf, bool))
    print(f"four cards, landmark-sharded global BA: {n_edges} edges, "
          f"{int(np.sum(np.asarray(st.pt_valid)))} landmarks over pt="
          f"{mesh.shape['pt']}; cost {c0:.1f} -> {c1:.1f} (single card "
          f"{c1s:.1f}, rel {rel:.2e}); max pose delta {dpose:.2e} m; max "
          f"pose error vs ground truth {err4 * 1e3:.2f} mm (single card "
          f"{err1 * 1e3:.2f} mm) (tolerance: cost1 rel <= 1e-2, pose delta "
          f"<= 1e-3 m: psum reduction order and the PCG's residual exit)",
          flush=True)
    check(int(n_edges) == int(stats.n_edges), "edge counts differ")
    check(rel <= 1e-2 and dpose <= 1e-3, "sharded global BA mismatch")


def run_four_cards() -> dict:
    devs = phase_device(4)[:4]
    phase_sharded_gba(devs)
    phase_dp(fixture_cfg(), DP_LENGTHS, devs)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)
    device = run_four_cards() if args.four_cards else run_one_card()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
