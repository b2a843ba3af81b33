"""CLI: run the engine on a TUM RGBD sequence or the synthetic fixture
(reference main.py / eval script, SURVEY.md L8).

Examples:
    python -m boslam_tpu.main --synthetic 100 --out traj.txt
    python -m boslam_tpu.main --tum /data/rgbd_dataset_freiburg1_xyz \
        --camera fr1 --out traj.txt --metrics run.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description="boslam_tpu RGBD SLAM")
    ap.add_argument("--tum", type=str, help="TUM sequence directory")
    ap.add_argument("--icl", type=str, help="ICL-NUIM sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--camera", choices=["fr1", "fr2", "fr3", "icl"],
                    default="fr1")
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config file; sections override the --camera "
                         "preset (see SlamConfig.from_yaml)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", type=str, default="trajectory.txt")
    ap.add_argument("--metrics", type=str, default=None)
    ap.add_argument("--metrics-tb", type=str, default=None,
                    help="TensorBoard logdir: mirror the per-frame metric "
                         "records as scalars (viewable next to --profile "
                         "traces)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save engine state every N keyframes")
    ap.add_argument("--checkpoint-dir", type=str, default="ckpt")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--profile", type=str, default=None,
                    help="jax.profiler trace logdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--global-ba", action="store_true",
                    help="run full-map BA after loop closures AND at exit")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize the multi-host runtime "
                         "(jax.distributed; fails without a cluster, so on "
                         "one host set BOSLAM_COORDINATOR=localhost:PORT "
                         "BOSLAM_NUM_PROCESSES=1) and run global BA "
                         "landmark-sharded over ALL visible devices; see "
                         "parallel/distributed.py for the launch recipe")
    ap.add_argument("--viz", type=str, default=None,
                    help="render the final 3D map + trajectory to this PNG")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local BA as a separate async device "
                         "computation (the reference's mapping thread); "
                         "keyframe frames pay only insert/fuse/cull")
    ap.add_argument("--mapping-device", type=int, default=None,
                    help="device index to run the async mapping solves on "
                         "(true tracking/mapping overlap; implies "
                         "--async-mapping)")
    ap.add_argument("--no-native-loader", action="store_true",
                    help="force the cv2 PNG decode path (default: the C++ "
                         "prefetching decoder when it builds/loads)")
    args = ap.parse_args()

    if args.distributed:
        # MUST run before anything that initializes the XLA backend (other
        # boslam imports create jnp constants at import time).
        from boslam_tpu.parallel.distributed import maybe_initialize

        maybe_initialize(force=True)

    from boslam_tpu.config import (
        ICL_NUIM, SlamConfig, TUM_FR1, TUM_FR2, TUM_FR3,
    )
    from boslam_tpu.geometry import align
    from boslam_tpu.io import icl_nuim
    from boslam_tpu.io import synthetic as synth
    from boslam_tpu.io import tum
    from boslam_tpu.slam import SlamSystem
    from boslam_tpu.utils import checkpoint as ckpt
    from boslam_tpu.utils.metrics import dump_metrics, profile_trace, summarize

    if args.icl:
        args.camera = "icl"
    cam = {"fr1": TUM_FR1, "fr2": TUM_FR2, "fr3": TUM_FR3,
           "icl": ICL_NUIM}[args.camera]
    cfg = SlamConfig(camera=cam)
    if args.config:
        cfg = SlamConfig.from_yaml(args.config, base=cfg)
    if args.global_ba:
        import dataclasses

        cfg = cfg.replace(
            loop=dataclasses.replace(cfg.loop, run_global_ba=True)
        )

    gt = None
    if args.synthetic:
        traj = synth.orbit_trajectory(args.synthetic, radius=0.6, loop=True)
        frames = synth.render_sequence(cfg.camera, traj)
        gt = (traj.timestamps, traj.poses_twc)
    elif args.tum:
        frames = tum.sequence(
            args.tum, cfg.camera.depth_factor, limit=args.limit,
            native=False if args.no_native_loader else None,
        )
        try:
            gt_ts, gt_poses = tum.read_groundtruth(f"{args.tum}/groundtruth.txt")
            gt = (gt_ts, gt_poses)
        except OSError:
            pass
    elif args.icl:
        frames = icl_nuim.sequence(
            args.icl, cfg.camera.depth_factor, limit=args.limit,
            native=False if args.no_native_loader else None,
        )
        try:
            gt = icl_nuim.read_groundtruth(args.icl)
        except OSError:
            pass
    else:
        ap.error("need --tum, --icl or --synthetic")

    ba_mesh = None
    if args.distributed:
        import jax

        from boslam_tpu.parallel.distributed import runtime_info
        from boslam_tpu.parallel.mesh import make_mesh

        print(f"[distributed] {runtime_info()}", file=sys.stderr)
        if jax.device_count() > 1:
            ba_mesh = make_mesh(seq=1)
            print(
                f"[distributed] global BA sharded over "
                f"pt={ba_mesh.shape['pt']} devices", file=sys.stderr,
            )

    import jax as _jax

    mapping_device = (
        _jax.devices()[args.mapping_device]
        if args.mapping_device is not None else None
    )
    slam = SlamSystem(cfg, seed=args.seed, ba_mesh=ba_mesh,
                      async_mapping=args.async_mapping,
                      mapping_device=mapping_device)
    if args.resume:
        ckpt.restore(args.resume, slam)
        print(f"resumed from {args.resume}: {slam.n_keyframes} keyframes",
              file=sys.stderr)

    last_ckpt_kf = slam.n_keyframes
    with profile_trace(args.profile):
        for i, (ts, rgb, depth) in enumerate(frames):
            slam.process_frame(ts, rgb, depth)
            m = slam.metrics[-1]
            if i % 25 == 0:
                print(
                    f"[{i}] kf={slam.n_keyframes} pts={slam.n_points} "
                    f"inl={m.get('n_inliers', 0)} {m.get('event', '')}",
                    file=sys.stderr,
                )
            if (
                args.checkpoint_every
                and slam.n_keyframes >= last_ckpt_kf + args.checkpoint_every
            ):
                ckpt.save(args.checkpoint_dir, slam)
                last_ckpt_kf = slam.n_keyframes

    if args.global_ba:
        slam.flush()
        rec = slam.run_global_ba()
        print(f"global BA: cost {rec['gba_cost0']:.1f} -> {rec['gba_cost1']:.1f} "
              f"({rec['gba_edges']} edges)", file=sys.stderr)
    ts_arr, poses = slam.trajectory()
    tum.save_trajectory(args.out, ts_arr, poses)
    print(f"wrote {len(ts_arr)} poses to {args.out}", file=sys.stderr)

    summary = summarize(slam.metrics)
    if gt is not None:
        import jax.numpy as jnp

        if args.synthetic:
            # A resumed run's pose history is longer than one groundtruth
            # pass; evaluate over the overlapping prefix.
            n = min(len(ts_arr), len(gt[1]))
            gt_assoc, mask, poses_eval = gt[1][:n], np.ones(n, bool), poses[:n]
        else:
            gt_assoc, mask = tum.associate_groundtruth(ts_arr, gt[0], gt[1])
            poses_eval = poses
        rmse, _ = align.ate_rmse(
            jnp.asarray(poses_eval[:, 4:]), jnp.asarray(gt_assoc[:, 4:]),
            jnp.asarray(mask.astype(np.float32)),
        )
        summary["ate_rmse_m"] = float(rmse)
    print(json.dumps(summary))

    if args.metrics:
        dump_metrics(args.metrics, slam.metrics)
    if args.metrics_tb:
        from boslam_tpu.utils.metrics import export_tensorboard

        export_tensorboard(args.metrics_tb, slam.metrics)
        print(f"wrote TensorBoard scalars to {args.metrics_tb}",
              file=sys.stderr)

    if args.viz:
        from boslam_tpu.viz import render_map

        render_map(
            slam.map, trajectory=poses,
            groundtruth=gt[1] if (gt is not None and args.synthetic) else None,
            out_path=args.viz,
        )
        print(f"wrote map view to {args.viz}", file=sys.stderr)


if __name__ == "__main__":
    main()
