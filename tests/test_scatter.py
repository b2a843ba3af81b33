"""Order-fixed scatters (utils/scatter.py) against sequential numpy
references, and the two solver paths built on them: the pose-graph normal
equations and the loop correction's camera re-anchoring."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from boslam_tpu.config import MapConfig, OrbConfig, SlamConfig
from boslam_tpu.geometry import se3
from boslam_tpu.mapping import empty_map
from boslam_tpu.solvers import pose_graph
from boslam_tpu.utils import scatter


@pytest.mark.parametrize("n_idx,n", [(64, 16), (300, 8)])
def test_set_last_matches_sequential_scatter(n_idx, n):
    rng = np.random.default_rng(n_idx)
    arr = rng.integers(0, 100, n).astype(np.int32)
    idx = rng.integers(-2, n + 3, n_idx).astype(np.int32)
    vals = rng.integers(100, 200, n_idx).astype(np.int32)
    ref = arr.copy()
    for i, v in zip(idx, vals):  # numpy semantics: in order, last wins
        if 0 <= i < n:
            ref[i] = v
    got = jax.jit(scatter.set_last)(arr, idx, vals)
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("shape", [(500,), (500, 3), (200, 6, 6)])
def test_segment_sum_matches_numpy(shape):
    rng = np.random.default_rng(len(shape))
    num = 37
    ids = rng.integers(-3, num + 4, shape[0]).astype(np.int32)
    data = rng.normal(size=shape).astype(np.float32)
    ref = np.zeros((num,) + shape[1:], np.float64)
    ok = (ids >= 0) & (ids < num)
    np.add.at(ref, ids[ok], data[ok].astype(np.float64))
    got = jax.jit(scatter.segment_sum, static_argnums=2)(data, ids, num)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


def _chain_graph(K, n_used, rng, noise):
    """A chain of ``n_used`` keyframe poses (true, and perturbed by
    ``noise``) with spanning edges measured from the truth plus one loop
    edge 0 <- last."""
    xi = np.zeros((n_used, 6), np.float32)
    xi[:, 3] = np.linspace(0, 2.0, n_used)
    xi[:, 1] = np.linspace(0, 0.6, n_used)
    true = np.asarray(se3.exp(jnp.asarray(xi)))
    pert = np.asarray(se3.retract(
        jnp.asarray(true),
        jnp.asarray(rng.normal(size=(n_used, 6)) * noise, jnp.float32),
    ))
    poses_true = np.asarray(empty_map(_cfg(K)).kf_pose).copy()
    poses_true[:n_used] = true
    poses0 = poses_true.copy()
    poses0[1:n_used] = pert[1:]
    i = np.concatenate([np.arange(1, n_used), [n_used - 1]]).astype(np.int32)
    j = np.concatenate([np.arange(0, n_used - 1), [0]]).astype(np.int32)
    t_meas = np.asarray(se3.pose_compose(
        jnp.asarray(poses_true[i]), se3.pose_inv(jnp.asarray(poses_true[j]))
    ))
    # Padding edges: invalid, one with a -1 endpoint (a culled loop edge).
    E = len(i) + 3
    pad_i = np.array([-1, 2, 0], np.int32)
    pad_j = np.array([3, -1, 0], np.int32)
    edges = pose_graph.PoseGraphEdges(
        i=jnp.asarray(np.concatenate([i, pad_i])),
        j=jnp.asarray(np.concatenate([j, pad_j])),
        t_meas=jnp.asarray(np.concatenate(
            [t_meas, np.tile(np.eye(1, 7, dtype=np.float32), (3, 1))]
        )),
        weight=jnp.full((E,), 100.0),
        valid=jnp.asarray(np.arange(E) < len(i)),
    )
    valid = np.arange(K) < n_used
    return poses_true, poses0, valid, edges


def _cfg(K):
    return SlamConfig(map=MapConfig(max_keyframes=K, max_points=64),
                      orb=OrbConfig(n_features=16))


def test_pose_graph_recovers_chain_with_loop():
    K, n_used = 12, 9
    rng = np.random.default_rng(0)
    true, poses0, valid, edges = _chain_graph(K, n_used, rng, 0.03)
    fixed = jnp.zeros(K, bool).at[0].set(True)
    out = pose_graph.optimize_pose_graph(
        _cfg(K), jnp.asarray(poses0), jnp.asarray(valid), edges, fixed
    )
    _, dt0 = se3.pose_distance(jnp.asarray(poses0[:n_used]),
                               jnp.asarray(true[:n_used]))
    _, dt = se3.pose_distance(out[:n_used], jnp.asarray(true[:n_used]))
    assert float(jnp.max(dt0)) > 0.02
    assert float(jnp.max(dt)) < 1e-3
    # Unused slots are untouched.
    np.testing.assert_array_equal(np.asarray(out[n_used:]), poses0[n_used:])


def test_close_loop_keeps_camera_relative_to_its_keyframe():
    """The camera sits several keyframes past the loop keyframe when the
    correction lands: it must move with its reference keyframe, not jump
    back to the loop keyframe's pose."""
    K, n_used = 12, 9
    rng = np.random.default_rng(1)
    true, poses0, valid, _ = _chain_graph(K, n_used, rng, 0.03)
    cfg = _cfg(K)
    st = empty_map(cfg)
    st = st._replace(
        kf_pose=jnp.asarray(poses0),
        kf_valid=jnp.asarray(valid),
        kf_seq=jnp.where(jnp.asarray(valid), jnp.arange(K), -1),
        n_kf=jnp.asarray(n_used, jnp.int32),
        spanning_parent=jnp.asarray(
            np.where(np.arange(K) < n_used, np.arange(K) - 1, -1), jnp.int32
        ),
    )
    kf_id, ref = 5, n_used - 1
    t_rel = se3.pose_compose(jnp.asarray(true[kf_id]),
                             se3.pose_inv(jnp.asarray(true[0])))
    pose_cw = se3.pose_compose(
        se3.exp(jnp.asarray([0.0, 0.05, 0.0, 0.1, 0.0, 0.0])),
        jnp.asarray(poses0[ref]),
    )
    N = cfg.orb.n_features
    st2, cam = pose_graph.close_loop_update(
        cfg, st, jnp.asarray(kf_id, jnp.int32), jnp.asarray(0, jnp.int32),
        t_rel, jnp.full((N,), -1, jnp.int32), jnp.zeros((N,), bool),
        pose_cw, jnp.asarray(ref, jnp.int32),
    )
    assert int(st2.n_loop_edges) == 1
    # The correction moved the reference keyframe ...
    _, moved = se3.pose_distance(st2.kf_pose[ref], st.kf_pose[ref])
    assert float(moved) > 1e-3
    # ... and the camera kept its pose relative to it.
    rel0 = se3.pose_compose(pose_cw, se3.pose_inv(st.kf_pose[ref]))
    rel1 = se3.pose_compose(cam, se3.pose_inv(st2.kf_pose[ref]))
    dr, dt = se3.pose_distance(rel1, rel0)
    assert float(dt) < 1e-5 and float(dr) < 1e-5
    _, to_loop_kf = se3.pose_distance(cam, st2.kf_pose[kf_id])
    assert float(to_loop_kf) > 0.3
