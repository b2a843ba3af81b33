"""The plain jnp hot paths against straightforward numpy references.

Covers the projection-window Hamming match (``hamming.match_top2`` with a
window mask), the FAST-9 + NMS rank maps (``frontend._fast_rank_maps``) and
the keypoint patch gather (``frontend._extract_patches_jnp``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from boslam_tpu.features import frontend as fe
from boslam_tpu.matching import hamming

_BIG = 1 << 20


# ---------------------------------------------------------------------------
# Projection-window Hamming match.
# ---------------------------------------------------------------------------

def _random_problem(rng, n=128, m=512, img=(640.0, 480.0)):
    desc_a = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    desc_b = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
    # Near-copies of frame descriptors, co-located, so real matches exist
    # under the Hamming threshold and inside the window.
    idx = rng.integers(0, n, size=m // 4)
    desc_b[: m // 4] = desc_a[idx]
    uv_a = rng.uniform(0, img, size=(n, 2)).astype(np.float32)
    uv_b = rng.uniform(0, img, size=(m, 2)).astype(np.float32)
    uv_b[: m // 4] = uv_a[idx] + 3.0
    r_a = rng.uniform(8.0, 40.0, size=(n,)).astype(np.float32)
    valid_a = rng.random(n) < 0.9
    vis_b = rng.random(m) < 0.8
    return desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b


def _jnp_match(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b, max_dist,
               ratio, mutual):
    uv_a, uv_b, r_a = jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(r_a)
    dist = hamming.hamming_matrix_mxu(jnp.asarray(desc_a),
                                      jnp.asarray(desc_b))
    d2 = jnp.sum((uv_a[:, None, :] - uv_b[None, :, :]) ** 2, axis=-1)
    return hamming.match_top2(
        dist, jnp.asarray(valid_a), jnp.asarray(vis_b), max_dist=max_dist,
        ratio=ratio, mutual=mutual, extra_mask=d2 <= (r_a[:, None] ** 2),
    )


def _brute_force(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b, max_dist,
                 ratio, mutual):
    """Row by row: best and second-best admissible map point, threshold,
    ratio test, and (mutual) the best row of the winning column."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    diff = uv_a[:, None, :] - uv_b[None, :, :]
    d2 = (diff * diff).sum(-1, dtype=np.float32)
    adm = (d2 <= r_a[:, None] * r_a[:, None]) & vis_b[None, :]
    n = desc_a.shape[0]
    idx = np.full(n, -1, np.int32)
    for i in range(n):
        cand = np.flatnonzero(adm[i])
        if not valid_a[i] or cand.size == 0:
            continue
        d = dist[i, cand]
        j = cand[np.argmin(d)]
        best = dist[i, j]
        rest = np.delete(d, np.argmin(d))
        second = rest.min() if rest.size else _BIG
        if best > max_dist or best > ratio * second:
            continue
        if mutual:
            rows = np.flatnonzero(adm[:, j] & valid_a)
            if rows[np.argmin(dist[rows, j])] != i:
                continue
        idx[i] = j
    return idx


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_window_match_matches_brute_force(mutual, ratio):
    prob = _random_problem(np.random.default_rng(0))
    idx, ok, dist = _jnp_match(*prob, max_dist=64, ratio=ratio,
                               mutual=mutual)
    ref = _brute_force(*prob, max_dist=64, ratio=ratio, mutual=mutual)
    assert (ref >= 0).sum() > 10  # the problem has real matches
    np.testing.assert_array_equal(np.asarray(idx), ref)
    np.testing.assert_array_equal(np.asarray(ok), ref >= 0)
    x = prob[0][ref >= 0] ^ prob[4][ref[ref >= 0]]
    np.testing.assert_array_equal(
        np.asarray(dist)[ref >= 0],
        np.unpackbits(x.view(np.uint8), axis=-1).sum(-1),
    )


def test_window_match_infinite_radius():
    """r = inf disables the window: plain whole-set brute force."""
    desc_a, uv_a, _, valid_a, desc_b, uv_b, vis_b = _random_problem(
        np.random.default_rng(1))
    r_inf = np.full(desc_a.shape[0], np.inf, np.float32)
    prob = (desc_a, uv_a, r_inf, valid_a, desc_b, uv_b, vis_b)
    idx, ok, _ = _jnp_match(*prob, max_dist=80, ratio=0.95, mutual=True)
    ref = _brute_force(*prob, max_dist=80, ratio=0.95, mutual=True)
    assert (ref >= 0).sum() > 10
    np.testing.assert_array_equal(np.asarray(idx), ref)
    np.testing.assert_array_equal(np.asarray(ok), ref >= 0)


# ---------------------------------------------------------------------------
# FAST-9 rank maps.
# ---------------------------------------------------------------------------

def _frame(h=240, w=320):
    from boslam_tpu.config import CameraConfig
    from boslam_tpu.io import synthetic

    cam = CameraConfig(width=w, height=h, fx=260.0, fy=260.0,
                       cx=w / 2.0, cy=h / 2.0)
    rgb, _ = synthetic.render_frame(
        cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    return fe.rgb_to_gray(rgb).astype(np.float32)


def _fast_score(img, t):
    """FAST-9 score on every pixel of the zero-padded image's 1-px halo
    region (rows/cols -1..h / -1..w): a corner has >= 9 circularly
    contiguous circle pixels all brighter than c + t (or all darker than
    c - t); its score is that polarity's summed margin over the circle."""
    h, w = img.shape
    p = np.pad(img, 4)
    c = p[3:h + 5, 3:w + 5]
    d = np.stack([p[3 + dy:h + 5 + dy, 3 + dx:w + 5 + dx] - c
                  for dx, dy in fe._CIRCLE])                 # [16, h+2, w+2]
    out = np.zeros_like(c)
    for sign in (1.0, -1.0):
        flag = sign * d > t
        run9 = np.zeros(c.shape, bool)
        for s in range(16):
            run9 |= np.all(flag[[(s + j) % 16 for j in range(9)]], axis=0)
        margin = np.zeros_like(c)
        for k in range(16):
            margin += np.maximum(sign * d[k] - t, 0.0)
        out = np.maximum(out, np.where(run9, margin, 0.0))
    return out


def _fast_rank_reference(img, t_hi, t_lo, border):
    h, w = img.shape

    def nms(score):
        win = np.stack([score[dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)])
        inner = score[1:h + 1, 1:w + 1]
        return np.where((inner >= win.max(0)) & (inner > 0), inner, 0.0)

    s_hi, s_lo = _fast_score(img, t_hi), _fast_score(img, t_lo)
    n_hi, n_lo = nms(s_hi), nms(s_lo)
    rows, cols = np.mgrid[0:h, 0:w]
    inb = ((rows >= border) & (rows < h - border)
           & (cols >= border) & (cols < w - border))
    rank = np.where(inb, np.where(n_hi > 0, n_hi + fe._BOOST_HI, n_lo), 0.0)
    raw_hi, raw_lo = s_hi[1:h + 1, 1:w + 1], s_lo[1:h + 1, 1:w + 1]
    return rank, np.where(raw_hi > 0, raw_hi, raw_lo)


@pytest.mark.parametrize("rows", [240, 230], ids=["full", "ragged_height"])
def test_fast_rank_maps_match_numpy_fast9(rows):
    img = _frame()[:rows]
    rank, raw = fe._fast_rank_maps(jnp.asarray(img), 20.0, 7.0, 17)
    rank_ref, raw_ref = _fast_rank_reference(img, 20.0, 7.0, 17)
    assert rank.shape == rank_ref.shape == (rows, 320)
    assert (rank_ref > 0).sum() > 100  # the frame has corners
    np.testing.assert_array_equal(np.asarray(rank) > 0, rank_ref > 0)
    np.testing.assert_allclose(np.asarray(rank), rank_ref, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(raw), raw_ref, rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# Patch gather.
# ---------------------------------------------------------------------------

def test_extract_patches_match_numpy_slicing():
    img = _frame()
    h, w = img.shape
    rng = np.random.default_rng(0)
    ys = rng.integers(0, h, size=64).astype(np.int32)
    xs = rng.integers(0, w, size=64).astype(np.int32)
    ys[:2], xs[:2] = (0, h - 1), (w - 1, 0)  # corners: clamped inward
    out = np.asarray(fe._extract_patches_jnp(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    half, p = fe.HALF, fe._PATCH
    assert out.shape == (64, p, p)
    for k in range(64):
        y = min(max(ys[k], half), h - half - 2)
        x = min(max(xs[k], half), w - half - 2)
        np.testing.assert_array_equal(
            out[k], img[y - half:y - half + p, x - half:x - half + p])
