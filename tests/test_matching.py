"""Hamming matcher unit tests (exact vs numpy reference, bf16 bit-matmul path vs exact)."""

import numpy as np
import jax.numpy as jnp

from boslam_tpu.matching import hamming


def np_hamming(a, b):
    abits = np.unpackbits(a.view(np.uint8), axis=-1)
    bbits = np.unpackbits(b.view(np.uint8), axis=-1)
    return (abits[:, None, :] != bbits[None, :, :]).sum(-1)


def test_popcount(rng):
    x = rng.integers(0, 2**32, size=1024, dtype=np.uint32)
    pc = np.asarray(hamming.popcount_u32(jnp.asarray(x)))
    ref = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(pc, ref)


def test_pack_unpack_roundtrip(rng):
    d = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    bits = hamming.unpack_bits(jnp.asarray(d))
    d2 = hamming.pack_bits(bits)
    np.testing.assert_array_equal(np.asarray(d2), d)


def test_hamming_exact_vs_numpy(rng):
    a = rng.integers(0, 2**32, size=(32, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(48, 8), dtype=np.uint32)
    d = np.asarray(hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d, np_hamming(a, b))


def test_hamming_mxu_vs_exact(rng):
    a = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(128, 8), dtype=np.uint32)
    d1 = np.asarray(hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    d2 = np.asarray(hamming.hamming_matrix_mxu(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d1, d2)


def test_match_top2_threshold_and_ratio():
    dist = jnp.asarray(
        [
            [0, 100, 100],   # clear best -> match 0
            [60, 62, 100],   # ratio-ambiguous under ratio=0.9
            [100, 100, 100], # all above threshold
        ],
        jnp.int32,
    )
    valid = jnp.ones(3, bool)
    idx, ok, d = hamming.match_top2(dist, valid, valid, max_dist=80, ratio=0.9, mutual=False)
    assert idx[0] == 0 and ok[0]
    assert not ok[1]  # 60 > 0.9 * 62
    assert not ok[2]
    # Without ratio test, row 1 matches.
    idx2, ok2, _ = hamming.match_top2(dist, valid, valid, max_dist=80, ratio=1.0, mutual=False)
    assert ok2[1] and idx2[1] == 0


def test_match_top2_mutual():
    # Rows 0 and 1 both prefer column 0; column 0 prefers row 0.
    dist = jnp.asarray([[1, 50], [2, 50]], jnp.int32)
    valid = jnp.ones(2, bool)
    idx, ok, _ = hamming.match_top2(dist, valid, valid, max_dist=80, ratio=1.0, mutual=True)
    assert ok[0] and idx[0] == 0
    assert not ok[1]


def test_match_top2_respects_validity(rng):
    a = rng.integers(0, 2**32, size=(8, 8), dtype=np.uint32)
    dist = hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(a))
    valid_a = jnp.ones(8, bool)
    valid_b = jnp.zeros(8, bool).at[0].set(True)
    idx, ok, _ = hamming.match_top2(dist, valid_a, valid_b, max_dist=256, ratio=1.0, mutual=False)
    assert np.all(np.asarray(idx)[np.asarray(ok)] == 0)
    assert ok[0]


def test_rotation_consistency_filter():
    """Planted outlier matches at odd relative rotations are removed; the
    dominant-rotation inliers survive (reference 30-bin histogram policy)."""
    import numpy as np
    from boslam_tpu.matching.rotation import rotation_consistency

    rng = np.random.default_rng(3)
    n = 200
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    roll = 0.4  # global camera roll between the two sides
    ang_b = ang_a - roll + rng.normal(0, 0.02, n).astype(np.float32)
    outlier = np.zeros(n, bool)
    outlier[: n // 4] = True  # 25% mismatches with random rotation
    ang_b[outlier] = rng.uniform(0, 2 * np.pi, outlier.sum())
    ok = np.ones(n, bool)
    keep = np.asarray(
        rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(ok))
    )
    # all true matches kept, great majority of outliers dropped
    assert keep[~outlier].mean() > 0.99
    assert keep[outlier].mean() < 0.25
    # sparse sets pass through unchanged (no-op below min_matches)
    ok_sparse = np.zeros(n, bool)
    ok_sparse[:8] = True
    keep2 = np.asarray(
        rotation_consistency(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(ok_sparse)
        )
    )
    assert (keep2 == ok_sparse).all()
