"""ORB-style feature frontend in plain jnp.

Replacement for ``cv2.ORB_create(...).detectAndCompute`` (reference frame
construction, SURVEY.md §2.2 row "OpenCV ORB"): 8-level image pyramid,
FAST-9 corner test with SAD score, 3x3 NMS, per-level top-k with a fixed
feature budget, intensity-centroid orientation, rotated-BRIEF 256-bit
descriptors packed as uint32[8], and per-keypoint depth backprojection
(reference camera.py contract, SURVEY.md §2.1).

Everything is static-shape: exactly ``cfg.orb.n_features`` keypoint slots per
frame, invalid slots masked (SURVEY.md §7.0).

The two hot stages avoid large gathers:

* **FAST + NMS** accumulates the 16 circle offsets as static slices of a
  padded image into ReLU margin maps and uint32 contiguity bitmasks — no
  [16, H, W] shifted stack; XLA fuses the chain (``_fast_rank_maps``).
* **Orientation + rotated BRIEF** samples each keypoint's 32x32 patch with
  the rotation quantized to ``N_ANGLE_BINS`` (the original ORB paper's 12°
  discretization): the 512 rotated sample positions per bin become constant
  one-hot row/column selection tables, so descriptor sampling is two
  einsums over the patch tensor instead of a 512-way per-keypoint gather.
  Patch extraction itself is a vmapped ``dynamic_slice``.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.features.pattern import HALF, PATTERN
from boslam_tpu.geometry import camera as cam_mod

# FAST radius-3 Bresenham circle, (dx, dy), clockwise from 12 o'clock.
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)

_LEVEL_BORDER = 17  # circle radius 3 + descriptor patch half 15 (rounded up)
_PATCH = 2 * HALF + 2  # 32: covers rotated offsets in [-15, 16)
N_ANGLE_BINS = 32   # rotated-BRIEF angle quantization (ORB paper: 12° bins)


class FrameFeatures(NamedTuple):
    """Per-frame feature set; all arrays have leading dim n_features."""

    uv: jnp.ndarray        # [N, 2] f32, level-0 pixel coords
    xyz: jnp.ndarray       # [N, 3] f32, camera-frame backprojection (0 if no depth)
    depth: jnp.ndarray     # [N] f32 metres (0 if invalid)
    desc: jnp.ndarray      # [N, 8] uint32 packed 256-bit descriptors
    angle: jnp.ndarray     # [N] f32 radians
    octave: jnp.ndarray    # [N] i32 pyramid level
    response: jnp.ndarray  # [N] f32 FAST score
    valid: jnp.ndarray     # [N] bool
    has_depth: jnp.ndarray # [N] bool


def distribute_features(n: int, n_levels: int, scale: float) -> List[int]:
    """Per-level keypoint budgets, geometric decay by 1/scale (ORB policy)."""
    inv = [1.0 / scale**l for l in range(n_levels)]
    total = sum(inv)
    ks = [max(8, int(round(n * w / total))) for w in inv]
    ks[0] += n - sum(ks)
    return ks


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [
        (max(int(round(h / scale**l)), 64), max(int(round(w / scale**l)), 64))
        for l in range(n_levels)
    ]


def _gauss7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Separable 7-tap Gaussian, SAME padding (edge replicate)."""
    pad = 3
    p = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    img = sum(kernel[i] * p[i : i + img.shape[0], :] for i in range(7))
    p = jnp.pad(img, ((0, 0), (pad, pad)), mode="edge")
    return sum(kernel[i] * p[:, i : i + img.shape[1]] for i in range(7))


def _contig9(mask: jnp.ndarray) -> jnp.ndarray:
    """uint32 circle bitmask (bits 0..15) -> True iff >= 9 contiguous
    (circular) bits set: duplicate into the high half-word, AND 9 shifts."""
    dup = mask | (mask << 16)
    acc = dup
    for s in range(1, 9):
        acc = acc & (dup >> s)
    return (acc & jnp.uint32(0xFFFF)) != 0


# Rank boosts for the grid-distributed selection.  Raw FAST scores are
# intensity margins < 16*255 = 4080, so these separate cleanly in f32.
_BOOST_HI = float(1 << 17)    # high-threshold corner beats any low-threshold one
_BOOST_CELL = float(1 << 18)  # per-cell best beats everything (>=1 kp/cell)


def _fast_rank_maps(level, t_hi: float, t_lo: float, border: int):
    """FAST-9 hi/lo score + 3x3 NMS + rank fusion.

    A pixel is a corner if >= 9 contiguous circle pixels are all brighter
    than c + t or all darker than c - t; the score is the summed intensity
    margin of the triggering polarity (standard FAST reimplementation
    score; cv2 parity is asserted by keypoint repeatability, not exact
    scores — SURVEY.md §4.2.1).  Returns (rank [H, W], raw [H, W]): rank =
    NMS'd + border-masked with hi corners boosted by _BOOST_HI; raw =
    pre-NMS score (hi where present, else lo) for sub-pixel refinement.
    """
    h, w = level.shape
    pad = 4
    p = jnp.pad(level, pad)
    th, tw = h + 2, w + 2  # compute region: 1 NMS halo each side
    center = jax.lax.slice(p, (3, 3), (3 + th, 3 + tw))
    zf = jnp.zeros((th, tw), jnp.float32)
    zu = jnp.zeros((th, tw), jnp.uint32)
    mb_hi, md_hi, mb_lo, md_lo = zf, zf, zf, zf
    kb_hi, kd_hi, kb_lo, kd_lo = zu, zu, zu, zu
    for k, (dx, dy) in enumerate(_CIRCLE):
        dx, dy = int(dx), int(dy)
        d = jax.lax.slice(p, (3 + dy, 3 + dx), (3 + dy + th, 3 + dx + tw)) - center
        bit = jnp.uint32(1 << k)
        mb_hi += jnp.maximum(d - t_hi, 0.0)
        md_hi += jnp.maximum(-d - t_hi, 0.0)
        mb_lo += jnp.maximum(d - t_lo, 0.0)
        md_lo += jnp.maximum(-d - t_lo, 0.0)
        kb_hi |= jnp.where(d > t_hi, bit, jnp.uint32(0))
        kd_hi |= jnp.where(-d > t_hi, bit, jnp.uint32(0))
        kb_lo |= jnp.where(d > t_lo, bit, jnp.uint32(0))
        kd_lo |= jnp.where(-d > t_lo, bit, jnp.uint32(0))

    score_hi = jnp.maximum(
        jnp.where(_contig9(kb_hi), mb_hi, 0.0),
        jnp.where(_contig9(kd_hi), md_hi, 0.0),
    )
    score_lo = jnp.maximum(
        jnp.where(_contig9(kb_lo), mb_lo, 0.0),
        jnp.where(_contig9(kd_lo), md_lo, 0.0),
    )

    def nms(score):
        mx = jax.lax.slice(score, (0, 0), (h, w))
        for ddy in range(3):
            for ddx in range(3):
                mx = jnp.maximum(
                    mx, jax.lax.slice(score, (ddy, ddx), (ddy + h, ddx + w))
                )
        inner = jax.lax.slice(score, (1, 1), (1 + h, 1 + w))
        return jnp.where((inner >= mx) & (inner > 0.0), inner, 0.0)

    nms_hi = nms(score_hi)
    nms_lo = nms(score_lo)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inb = (
        (rows >= border) & (rows < h - border)
        & (cols >= border) & (cols < w - border)
    )
    rank = jnp.where(nms_hi > 0, nms_hi + _BOOST_HI, nms_lo)
    rank = jnp.where(inb, rank, 0.0)
    raw_hi = jax.lax.slice(score_hi, (1, 1), (1 + h, 1 + w))
    raw_lo = jax.lax.slice(score_lo, (1, 1), (1 + h, 1 + w))
    raw = jnp.where(raw_hi > 0, raw_hi, raw_lo)
    return rank, raw


def _grid_select(rank: jnp.ndarray, k: int, rows: int, cols: int):
    """Spatially distributed top-k (reference ORB grid/quadtree policy,
    SURVEY.md §2.2 ORB row).

    ``rank`` is a [H, W] ranking map (0 = no corner).  Selection: per grid
    cell take the top-q candidates (q caps any cell at ~2x its fair share),
    boost each cell's best by _BOOST_CELL so every occupied cell places at
    least one keypoint before any cell places two, then global top-k.

    Returns (ys [k], xs [k], chosen_rank [k]).
    """
    h, w = rank.shape
    n_cells = rows * cols
    ch = -(-h // rows)
    cw = -(-w // cols)
    q = min(max(2, -(-2 * k // n_cells)), k)
    padded = jnp.zeros((rows * ch, cols * cw), rank.dtype).at[:h, :w].set(rank)
    cells = padded.reshape(rows, ch, cols, cw).transpose(0, 2, 1, 3).reshape(
        n_cells, ch * cw
    )
    topv, topi = jax.lax.top_k(cells, q)                     # [n_cells, q]
    topv = topv.at[:, 0].add(jnp.where(topv[:, 0] > 0, _BOOST_CELL, 0.0))
    cell_r = jnp.arange(n_cells) // cols
    cell_c = jnp.arange(n_cells) % cols
    ys = cell_r[:, None] * ch + topi // cw                   # [n_cells, q]
    xs = cell_c[:, None] * cw + topi % cw
    flat_v = jnp.where(topv > 0, topv, 0.0).reshape(-1)
    best, sel = jax.lax.top_k(flat_v, k)
    return ys.reshape(-1)[sel], xs.reshape(-1)[sel], best


def _subpixel_offsets(score, ys, xs):
    """Per-keypoint sub-pixel offsets from a 1D parabola fit per axis on the
    raw (pre-NMS) FAST score map; clamped to [-0.5, 0.5].

    One flat 5-value gather per keypoint (center + 4 axis neighbors)
    instead of a vmapped 3x3 dynamic_slice: a single [K, 5] take kernel
    replaces K serialized slice dispatches (~0.8 ms -> noise at K=512)."""
    h, w = score.shape
    ys = jnp.clip(ys, 1, h - 2)
    xs = jnp.clip(xs, 1, w - 2)
    base = ys * w + xs                                       # [K]
    offs = jnp.asarray([0, -1, 1, -w, w], jnp.int32)         # c, x-, x+, y-, y+
    vals = jnp.take(score.reshape(-1), base[:, None] + offs[None, :], axis=0)
    c = vals[:, 0]

    def fit(lo, hi):
        denom = 2.0 * c - lo - hi
        off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (hi - lo) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    return fit(vals[:, 1], vals[:, 2]), fit(vals[:, 3], vals[:, 4])


@functools.lru_cache(maxsize=1)
def _orient_weights():
    """Intensity-centroid moment weights on the 32x32 patch (31x31 circular
    support, zero last row/col)."""
    dy, dx = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    circ = (dx**2 + dy**2 <= HALF**2).astype(np.float32)
    wx = np.zeros((_PATCH, _PATCH), np.float32)
    wy = np.zeros((_PATCH, _PATCH), np.float32)
    wx[: 2 * HALF + 1, : 2 * HALF + 1] = dx * circ
    wy[: 2 * HALF + 1, : 2 * HALF + 1] = dy * circ
    return wx, wy


@functools.lru_cache(maxsize=1)
def _brief_tables():
    """Constant one-hot sample-selection tables for the binned rotated BRIEF.

    For each of N_ANGLE_BINS quantized angles, the 512 pattern points (256
    pairs) rotate and round to integer patch offsets exactly as the exact-
    rotation formulation would at that angle; the row/column indices become
    one-hot matrices so descriptor sampling is two tensor contractions:
    ``val[k,s] = col[b_k,s,:] · (row[b_k,s,:] @ patch_k)``.

    Returns (row_oh [A, 512, 32], col_oh [A, 512, 32]) float32.
    """
    pts = np.concatenate([PATTERN[:, 0:2], PATTERN[:, 2:4]], axis=0)  # [512,2] (x,y)
    a = N_ANGLE_BINS
    row_oh = np.zeros((a, 512, _PATCH), np.float32)
    col_oh = np.zeros((a, 512, _PATCH), np.float32)
    for b in range(a):
        th = 2.0 * np.pi * b / a
        ca, sa = np.cos(th), np.sin(th)
        xr = pts[:, 0] * ca - pts[:, 1] * sa
        yr = pts[:, 0] * sa + pts[:, 1] * ca
        i = np.clip(np.round(yr).astype(np.int64) + HALF, 0, _PATCH - 1)
        j = np.clip(np.round(xr).astype(np.int64) + HALF, 0, _PATCH - 1)
        row_oh[b, np.arange(512), i] = 1.0
        col_oh[b, np.arange(512), j] = 1.0
    return row_oh, col_oh


def _extract_patches_jnp(img, ys, xs):
    """[K, 32, 32] patches at (ys, xs) via vmapped dynamic_slice; centres
    are clamped so every patch lies inside the image."""
    h, w = img.shape
    ys = jnp.clip(ys, HALF, h - HALF - 2)
    xs = jnp.clip(xs, HALF, w - HALF - 2)

    def one(y, x):
        return jax.lax.dynamic_slice(img, (y - HALF, x - HALF), (_PATCH, _PATCH))

    return jax.vmap(one)(ys, xs)


def orient_and_brief(patches):
    """Orientation (intensity centroid) + binned rotated-BRIEF descriptor
    for a batch of 32x32 patches.  Returns (angle [K] f32, desc [K, 8] u32).

    The angle is continuous (atan2 of the patch moments — used by rotation-
    consistency matching); only the descriptor sampling quantizes it to
    N_ANGLE_BINS (the ORB paper's discretized steered BRIEF)."""
    # HIGHEST precision: the one-hot contractions are gathers and must
    # return the patch intensities exactly.  At the GPU default (TF32
    # products) they come back rounded to 10 mantissa bits, which flips
    # near-tied BRIEF tests: 13 % of keypoints differed from the CPU in
    # at least one descriptor bit on the bench fixture on an H100.
    hi = jax.lax.Precision.HIGHEST
    wx, wy = _orient_weights()
    m10 = jnp.einsum("kij,ij->k", patches, jnp.asarray(wx), precision=hi)
    m01 = jnp.einsum("kij,ij->k", patches, jnp.asarray(wy), precision=hi)
    angle = jnp.arctan2(m01, m10)

    row_oh, col_oh = _brief_tables()
    a = N_ANGLE_BINS
    b = jnp.mod(jnp.round(angle * (a / (2.0 * np.pi))).astype(jnp.int32), a)
    boh = jax.nn.one_hot(b, a, dtype=patches.dtype)          # [K, A]
    rowsel = jnp.einsum("ka,asi->ksi", boh, jnp.asarray(row_oh), precision=hi)
    colsel = jnp.einsum("ka,asj->ksj", boh, jnp.asarray(col_oh), precision=hi)
    rows = jnp.einsum("ksi,kij->ksj", rowsel, patches,
                      precision=hi)                          # [K, 512, 32]
    vals = jnp.sum(colsel * rows, axis=-1)                   # [K, 512]
    v1, v2 = vals[:, :256], vals[:, 256:]
    bits = (v1 < v2).astype(jnp.uint32)                      # [K, 256]
    packed = jnp.sum(
        bits.reshape(-1, 8, 32) << jnp.arange(32, dtype=jnp.uint32)[None, None, :],
        axis=2,
        dtype=jnp.uint32,
    )
    return angle, packed


@functools.partial(jax.jit, static_argnums=(2,))
def extract_features(gray, depth, cfg: SlamConfig) -> FrameFeatures:
    """gray: [H, W] f32 in [0, 255]; depth: [H, W] f32 metres (0 = invalid)."""
    orb = cfg.orb
    cam = cfg.camera
    h, w = cam.height, cam.width
    shapes = pyramid_shapes(h, w, orb.n_levels, orb.scale_factor)
    budgets = distribute_features(orb.n_features, orb.n_levels, orb.scale_factor)
    kernel = jnp.asarray(_gauss7())
    t_hi, t_lo = float(orb.fast_threshold), float(orb.fast_threshold_min)

    uv_all, patch_all, oct_all, resp_all, val_all = [], [], [], [], []
    level = gray
    for l, (hl, wl) in enumerate(shapes):
        if l > 0:
            level = jax.image.resize(level, (hl, wl), "linear")
        blurred = _blur(level, kernel)
        # Adaptive FAST threshold (reference ORB per-cell retry at the min
        # threshold): hi + lo scores in one pass; hi corners outrank lo ones
        # so lo corners only fill weak cells.
        rank, raw_score = _fast_rank_maps(level, t_hi, t_lo, _LEVEL_BORDER)
        k = budgets[l]
        ys, xs, top = _grid_select(rank, k, orb.grid_rows, orb.grid_cols)
        valid = top > 0
        patches = _extract_patches_jnp(blurred, ys, xs)
        # Sub-pixel refinement: 1D quadratic fit on the raw FAST score along
        # each axis (integer detection adds +-0.5 px noise that dominates
        # pose accuracy on clean data).
        dxs, dys = _subpixel_offsets(raw_score, ys, xs)
        xf = xs.astype(jnp.float32) + dxs
        yf = ys.astype(jnp.float32) + dys
        # Level-l -> level-0 coords under jax.image.resize's pixel-center
        # alignment: x0 = (x_l + 0.5) * (W0 / W_l) - 0.5 (the actual per-level
        # scale, not the nominal 1.2^l — the nominal form introduces a
        # systematic +0.5*(s-1) px bias that tilts pose optimization).
        sx, sy = w / wl, h / hl
        uv = jnp.stack(
            [(xf + 0.5) * sx - 0.5, (yf + 0.5) * sy - 0.5],
            -1,
        )
        uv_all.append(uv)
        patch_all.append(patches)
        oct_all.append(jnp.full((k,), l, jnp.int32))
        # Response = raw FAST margin (boost-free), comparable across cells.
        resp_all.append(raw_score[jnp.clip(ys, 0, hl - 1), jnp.clip(xs, 0, wl - 1)])
        val_all.append(valid)

    # One batched orientation + descriptor pass over all levels' patches
    # (the einsums amortize across the whole frame budget).
    angle, desc = orient_and_brief(jnp.concatenate(patch_all))

    uv = jnp.concatenate(uv_all)
    valid = jnp.concatenate(val_all)
    # Depth lookup at level-0 coords.  The depth map may arrive block-
    # reduced by cam.depth_wire_stride (slam.depth_wire): wire sample
    # [i, j] summarizes pixel block [i*s:(i+1)*s, j*s:(j+1)*s], so the
    # lookup maps a pixel to its OWN block, floor((u+0.5)/s) — not to the
    # nearest strided sample, which reads across block (and possibly
    # object) boundaries.
    s = cam.depth_wire_stride
    hs, ws = cam.depth_wire_shape
    if s == 1:
        ui = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, ws - 1)
        vi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, hs - 1)
    else:
        ui = jnp.clip(
            jnp.floor((uv[:, 0] + 0.5) / s).astype(jnp.int32), 0, ws - 1
        )
        vi = jnp.clip(
            jnp.floor((uv[:, 1] + 0.5) / s).astype(jnp.int32), 0, hs - 1
        )
    z = depth[vi, ui]
    has_depth = valid & cam_mod.valid_depth(cam, z)
    z = jnp.where(has_depth, z, 0.0)
    xyz = cam_mod.backproject(cam, uv, z)
    return FrameFeatures(
        uv=uv,
        xyz=jnp.where(has_depth[:, None], xyz, 0.0),
        depth=z,
        desc=desc,
        angle=angle,
        octave=jnp.concatenate(oct_all),
        response=jnp.concatenate(resp_all),
        valid=valid,
        has_depth=has_depth,
    )


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """Host-side u8 RGB -> f32 gray in [0, 255] (ITU-R BT.601, cv2-compatible)."""
    rgb = rgb.astype(np.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
