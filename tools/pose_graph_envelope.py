"""Measure the dense pose-graph solve's scale envelope (VERDICT r4 item 9).

The essential-graph optimizer assembles dense [K*6, K*6] normal equations
(solvers/pose_graph.py): fine at the engine's K=256 cap, but the
reference family runs thousands of keyframes on fr2-scale sequences.  This
tool times the solve at K = 256 / 512 / 1024 (wall + per-iteration, on the
current backend) and prints peak H memory, so README can state exactly where
the dense formulation stops being viable.

Run: python tools/pose_graph_envelope.py [--cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512, 1024])
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from boslam_tpu.config import SlamConfig
    from boslam_tpu.geometry import se3
    from boslam_tpu.solvers.pose_graph import (
        PoseGraphEdges, optimize_pose_graph,
    )

    cfg = SlamConfig()
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    for K in args.sizes:
        rng = np.random.default_rng(0)
        # Chain + 20% random extra covis edges + one loop edge, like a real
        # essential graph; ground truth a noisy circle.
        th = np.linspace(0, 2 * np.pi, K, endpoint=False)
        t_gt = np.stack([np.cos(th), np.sin(th), 0 * th], -1) * 5.0
        q_gt = np.zeros((K, 4)); q_gt[:, 0] = 1.0
        poses_gt = jnp.asarray(
            np.concatenate([q_gt, t_gt], -1), jnp.float32
        )
        ei = np.arange(K - 1)
        ej = ei + 1
        n_extra = K // 5
        xi = rng.integers(0, K - 2, n_extra)
        xj = xi + rng.integers(2, 8, n_extra)
        ei = np.concatenate([ei, xi, [K - 1]])
        ej = np.concatenate([ej, np.minimum(xj, K - 1), [0]])
        E = len(ei)
        t_meas = se3.pose_compose(
            poses_gt[ei], se3.pose_inv(poses_gt[ej])
        )
        edges = PoseGraphEdges(
            i=jnp.asarray(ei, jnp.int32), j=jnp.asarray(ej, jnp.int32),
            t_meas=t_meas, weight=jnp.ones((E,), jnp.float32),
            valid=jnp.ones((E,), bool),
        )
        noise = rng.normal(size=(K, 3)).astype(np.float32) * 0.05
        init = poses_gt.at[:, 4:].add(jnp.asarray(noise))
        fixed = jnp.zeros((K,), bool).at[0].set(True)
        valid = jnp.ones((K,), bool)

        run = jax.jit(
            lambda p: optimize_pose_graph(cfg, p, valid, edges, fixed)
        )
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(init))
        t_compile = time.perf_counter() - t0
        ts = []
        for i in range(3):
            salted = init.at[0, 4].add(1e-30 * (i + 1))
            t0 = time.perf_counter()
            out = jax.block_until_ready(run(salted))
            ts.append(time.perf_counter() - t0)
        err = float(jnp.max(jnp.linalg.norm(
            out[:, 4:] - poses_gt[:, 4:], axis=-1
        )))
        h_mb = (K * 6) ** 2 * 4 / 1e6
        print(
            f"K={K:5d}: E={E:5d} solve={np.median(ts)*1e3:8.1f} ms "
            f"(compile {t_compile:.1f}s)  H={h_mb:7.1f} MB  "
            f"max pose err={err*1e3:.1f} mm",
            flush=True,
        )


if __name__ == "__main__":
    main()
