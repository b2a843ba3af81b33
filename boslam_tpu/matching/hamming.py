"""Batched Hamming descriptor matching.

Replacement for ``cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch``
(SURVEY.md §2.2 row "OpenCV BFMatcher").  Descriptors are 256-bit, packed as
``uint32[8]``.  Two distance paths:

- ``hamming_matrix``: exact XOR + popcount (bit-twiddling popcount; no
  scalar loops) — the plain reference.
- ``hamming_matrix_mxu``: popcount(a XOR b) = |a| + |b| - 2 a.b for 0/1 bit
  vectors, so the full N x M distance matrix is one bf16 matmul with f32
  accumulation (tensor cores on a GPU) — the frame-vs-whole-map path.

Both are ``vmap``-batchable across frames.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def popcount_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Vectorized 32-bit popcount (Hacker's Delight), returns int32."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """[..., 8] uint32 -> [..., 256] {0,1} float32 bit columns (LSB-first)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    return bits.reshape(*desc.shape[:-1], 256).astype(jnp.float32)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] {0,1} -> [..., 8] uint32 (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).astype(jnp.uint32)
    return jnp.sum(b << jnp.arange(32, dtype=jnp.uint32), axis=-1, dtype=jnp.uint32)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Exact Hamming distances: [N, 8]u32 x [M, 8]u32 -> [N, M] int32."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return jnp.sum(popcount_u32(x), axis=-1)


def hamming_matrix_mxu(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distances via one bf16 matmul (exact: 0/1 operands, f32 sums).

    popcount(a ^ b) = popcount(a) + popcount(b) - 2 * dot(bits_a, bits_b).
    """
    bits_a = unpack_bits(desc_a).astype(jnp.bfloat16)
    bits_b = unpack_bits(desc_b).astype(jnp.bfloat16)
    dot = jnp.dot(bits_a, bits_b.T, preferred_element_type=jnp.float32)
    na = jnp.sum(popcount_u32(desc_a), axis=-1).astype(jnp.float32)
    nb = jnp.sum(popcount_u32(desc_b), axis=-1).astype(jnp.float32)
    return jnp.round(na[:, None] + nb[None, :] - 2.0 * dot).astype(jnp.int32)


# Host scalar, NOT jnp.int32: a module-level device scalar becomes a
# closed-over constant in every program that traces this file, and MLIR
# lowering materializes it with a device->host read.
_BIG = np.int32(1 << 20)


def match_top2(
    dist: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_dist: int,
    ratio: float = 1.0,
    mutual: bool = True,
    extra_mask: jnp.ndarray | None = None,
):
    """Row-wise best + second-best with ratio test, threshold, mutual check.

    Args:
      dist: [N, M] integer distances.
      valid_a: [N] bool, valid_b: [M] bool.
      extra_mask: optional [N, M] bool of admissible pairs (projection window,
        BoW bucket, ...).

    Returns:
      (match_idx [N] int32 into B, -1 if unmatched; match_mask [N] bool;
       match_dist [N] int32)
    """
    masked = jnp.where(valid_b[None, :], dist, _BIG)
    if extra_mask is not None:
        masked = jnp.where(extra_mask, masked, _BIG)
    best_idx = jnp.argmin(masked, axis=1)
    n = masked.shape[0]
    rows = jnp.arange(n)
    best = masked[rows, best_idx]
    second = jnp.min(masked.at[rows, best_idx].set(_BIG), axis=1)
    ok = valid_a & (best <= max_dist) & (
        best.astype(jnp.float32) <= ratio * second.astype(jnp.float32)
    )
    if mutual:
        # Column-wise winner must point back at the row.
        col_best = jnp.argmin(jnp.where(valid_a[:, None], masked, _BIG), axis=0)
        ok = ok & (col_best[best_idx] == rows)
    idx = jnp.where(ok, best_idx, -1)
    return idx.astype(jnp.int32), ok, best.astype(jnp.int32)
