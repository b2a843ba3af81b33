"""BoW-bucketed descriptor matching (reference ``search_by_bow``, SURVEY.md
§2.1 Matcher row / §3.2 relocalization path).

The reference restricts candidate pairs to keypoints falling in the same
DBoW3 vocabulary node, turning an O(N·M) search into per-bucket searches.
Dense form: compute both sides' word ids (one Hamming matmul against
the vocabulary each) and use word equality as the admissibility mask of the
full distance matrix — same pruning semantics, still one batched matmul, no
index chasing.
"""

from __future__ import annotations

import jax.numpy as jnp

from boslam_tpu.matching import hamming
from boslam_tpu.matching.rotation import rotation_consistency


def search_by_bow(
    vocab,
    desc_a,
    valid_a,
    desc_b,
    valid_b,
    max_dist: int,
    ratio: float = 0.9,
    mutual: bool = True,
    angle_a=None,
    angle_b=None,
):
    """Match A-side descriptors to B-side within shared vocabulary words.

    Returns (idx [N] i32 into B or -1, ok [N] bool, dist [N] i32).
    """
    wa = hamming.hamming_matrix_mxu(desc_a, vocab).argmin(axis=1)
    wb = hamming.hamming_matrix_mxu(desc_b, vocab).argmin(axis=1)
    bucket = wa[:, None] == wb[None, :]
    dist = hamming.hamming_matrix_mxu(desc_a, desc_b)
    idx, ok, mdist = hamming.match_top2(
        dist, valid_a, valid_b, max_dist=max_dist, ratio=ratio,
        mutual=mutual, extra_mask=bucket,
    )
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency(
            angle_a, angle_b[jnp.clip(idx, 0, angle_b.shape[0] - 1)], ok
        )
        idx = jnp.where(ok, idx, -1)
    return idx, ok, mdist
