"""Loop-edge accuracy probe: each closed loop's measured T_rel vs
groundtruth on the hall-clover bench fixture.

The loop edge is the single most influential measurement in the engine
(the pose graph rigidly trusts it), so its error against the synthetic
groundtruth is the sharpest check on the verification pipeline.

Run: PYTHONPATH=<repo root> python tools/loop_accuracy.py [--frames 450]
"""

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=450)
    ap.add_argument("--depth-stride", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-cull", action="store_true",
                    help="disable redundancy keyframe culling so loop edges "
                         "survive to the end of the run for measurement "
                         "(a cull touching an endpoint invalidates the "
                         "edge by design)")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from boslam_tpu.geometry import align, se3
    from boslam_tpu.io import synthetic
    from boslam_tpu.slam import SlamSystem

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    cfg = bench._tracking_cfg(args)
    if args.no_cull:
        import dataclasses

        cfg = cfg.replace(
            map=dataclasses.replace(cfg.map, kf_cull_redundancy=2.0)
        )

    traj = synthetic.clover_trajectory(
        args.frames, n_petals=3, radius=2.5, yaw_amplitude=0.4
    )
    rng = np.random.default_rng(3)
    frames = []
    t0 = time.perf_counter()
    for ts, pose in zip(traj.timestamps, traj.poses_twc):
        rgb, depth = synthetic.render_frame(cfg.camera, pose, room_scale=2.5)
        depth = depth + rng.normal(size=depth.shape).astype(np.float32) * (
            0.025 * depth
        )
        frames.append(bench._wire(cfg, float(ts), rgb, depth))
    print(f"render {time.perf_counter()-t0:.0f}s", flush=True)

    t0 = time.perf_counter()
    slam = SlamSystem(cfg)
    for f in frames:
        slam.feed(*f)
    slam.flush()
    print(
        f"run {time.perf_counter()-t0:.0f}s loops={slam.n_loops_closed}",
        flush=True,
    )

    gt_twc = traj.poses_twc
    n_edges = int(slam.map.n_loop_edges)
    le = np.asarray(slam.map.loop_edges)[:n_edges]
    lr = np.asarray(slam.map.loop_rel)[:n_edges]
    kf_f = np.asarray(slam.map.kf_frame_idx)
    for (i, j), rel in zip(le, lr):
        if i < 0 or j < 0:
            print("loop edge invalidated by a later keyframe cull",
                  flush=True)
            continue
        fi, fj = int(kf_f[i]), int(kf_f[j])
        Ti = se3.pose_inv(jnp.asarray(gt_twc[fi]))
        Tj = se3.pose_inv(jnp.asarray(gt_twc[fj]))
        rel_gt = se3.pose_compose(Ti, se3.pose_inv(Tj))
        dr, dt = se3.pose_distance(jnp.asarray(rel), rel_gt)
        print(
            f"loop kf{i}(frame {fi}) <- kf{j}(frame {fj}): "
            f"T_rel err {float(dt)*1e3:.1f} mm, {float(dr)*57.3:.2f} deg",
            flush=True,
        )
    _, est = slam.trajectory()
    n = min(len(est), len(gt_twc))
    rmse, _ = align.ate_rmse(
        jnp.asarray(est[:n, 4:]), jnp.asarray(gt_twc[:n, 4:])
    )
    print(f"ATE {float(rmse):.4f} m", flush=True)


if __name__ == "__main__":
    main()
