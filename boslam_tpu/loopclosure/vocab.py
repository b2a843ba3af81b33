"""Binary visual vocabulary + BoW database as dense arrays.

Replaces DBoW3 (SURVEY.md §2.2 row "DBoW3"): instead of a C++ hierarchical
k-means tree with an inverted index, the vocabulary is a flat table of
``vocab_size`` 256-bit words trained *online* by k-majority (binary k-means)
on the map's own descriptors, word assignment is one Hamming matmul, a
BoW vector is a segment-sum histogram, and database scoring is a dense
``[K, V] @ [V]`` matmul — O(1) index chasing replaced by batched linear
algebra over the whole keyframe set.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig
from boslam_tpu.matching import hamming


# Parallel temporal-consistency groups (reference mvConsistentGroups: every
# candidate group is checked against ALL of last keyframe's groups, so a
# genuine revisit builds its streak even while aliased-texture candidates
# outscore it on individual keyframes).
N_STREAKS = 4


class LoopState(NamedTuple):
    vocab: jnp.ndarray        # [V, 8] u32 word descriptors
    vocab_ready: jnp.ndarray  # scalar bool
    kf_bow: jnp.ndarray       # [K, V] f32 L2-normalized tf-idf vectors
    # Per-word inverse document frequency, computed at vocabulary
    # (re)train time (reference: DBoW3 TF_IDF weighting).  Without it,
    # high-frequency words — floor/wall texture — dilute similarity scores
    # and alias unrelated keyframes (the r3 streak/inlier-gate fight).
    idf: jnp.ndarray          # [V] f32 (ones before training)
    # Temporal-consistency tracker (reference: >= 3 consecutive hits over
    # overlapping covisibility groups, N_STREAKS tracked in parallel).
    streak_kf: jnp.ndarray    # [N_STREAKS] i32 candidate group anchors (-1)
    streak_len: jnp.ndarray   # [N_STREAKS] i32


def empty_loop_state(cfg: SlamConfig) -> LoopState:
    V = cfg.loop.vocab_size
    K = cfg.map.max_keyframes
    return LoopState(
        vocab=jnp.zeros((V, 8), jnp.uint32),
        vocab_ready=jnp.zeros((), bool),
        kf_bow=jnp.zeros((K, V)),
        idf=jnp.ones((V,)),
        streak_kf=jnp.full((N_STREAKS,), -1, jnp.int32),
        streak_len=jnp.zeros((N_STREAKS,), jnp.int32),
    )


@functools.partial(jax.jit, static_argnums=(0, 3))
def train_vocab(cfg: SlamConfig, loop: LoopState, map_state, iters: int = 3) -> LoopState:
    """k-majority vocabulary training on the map's keyframe descriptors.

    Init: a deterministic stride sample of valid descriptors.  Lloyd steps:
    assign every descriptor to its nearest word (Hamming via matmul), recompute
    each word as the bitwise majority of its cluster.  Empty clusters keep
    their previous word.  Then recompute all keyframe BoW vectors.
    """
    V = cfg.loop.vocab_size
    K, N = map_state.kf_obs_pt.shape
    desc = map_state.kf_desc.reshape(K * N, 8)
    valid = (map_state.kf_kp_valid & map_state.kf_valid[:, None]).reshape(K * N)
    # Deterministic sample: spread indices over the valid set.
    vidx, = jnp.nonzero(valid, size=K * N, fill_value=0)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    take = (jnp.arange(V) * n_valid) // V
    words = desc[vidx[jnp.clip(take, 0, K * N - 1)]]

    bits = hamming.unpack_bits(desc)  # [KN, 256]
    wvalid = valid.astype(jnp.float32)

    def lloyd(words, _):
        d = hamming.hamming_matrix_mxu(desc, words)       # [KN, V]
        assign = jnp.argmin(d, axis=1)
        seg = jnp.where(valid, assign, V)
        counts = jax.ops.segment_sum(wvalid, seg, num_segments=V + 1)[:V]
        sums = jax.ops.segment_sum(
            bits * wvalid[:, None], seg, num_segments=V + 1
        )[:V]
        maj = (sums * 2.0 > counts[:, None]).astype(jnp.float32)
        new_words = hamming.pack_bits(maj)
        words = jnp.where((counts > 0)[:, None], new_words, words)
        return words, None

    words, _ = jax.lax.scan(lloyd, words, None, length=iters)

    loop = loop._replace(vocab=words, vocab_ready=jnp.ones((), bool))
    # Per-word idf over the current keyframe set: ln((1 + K) / (1 + df))
    # with df = number of keyframes containing the word (smoothed so words
    # seen everywhere score ~0 and never divide by zero).  One [K, V]
    # presence reduction at train time; scoring stays a plain matmul.
    def tf_of(k):
        return _tf_histogram(cfg, loop.vocab, map_state.kf_desc[k],
                             map_state.kf_kp_valid[k] & map_state.kf_valid[k])

    tf_all = jax.vmap(tf_of)(jnp.arange(K))                     # [K, V]
    n_kf = jnp.maximum(jnp.sum(map_state.kf_valid), 1)
    df = jnp.sum((tf_all > 0) & map_state.kf_valid[:, None], axis=0)
    idf = jnp.log((1.0 + n_kf) / (1.0 + df.astype(jnp.float32)))
    loop = loop._replace(idf=idf)
    # Refresh all keyframe BoW rows under the new vocabulary + idf.
    kf_bow = jax.vmap(lambda tf: _normalize(tf * idf))(tf_all)
    return loop._replace(kf_bow=kf_bow)


def _tf_histogram(cfg: SlamConfig, vocab, desc, valid):
    V = cfg.loop.vocab_size
    d = hamming.hamming_matrix_mxu(desc, vocab)   # [N, V]
    assign = jnp.argmin(d, axis=1)
    seg = jnp.where(valid, assign, V)
    return jax.ops.segment_sum(
        jnp.ones_like(seg, jnp.float32), seg, num_segments=V + 1
    )[:V]


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)


def _bow_vector(cfg: SlamConfig, vocab, idf, desc, valid):
    return _normalize(_tf_histogram(cfg, vocab, desc, valid) * idf)


def word_ids(vocab, desc, valid):
    """[N] i32 vocabulary word per descriptor (argmin Hamming via matmul)."""
    d = hamming.hamming_matrix_mxu(desc, vocab)
    w = jnp.argmin(d, axis=1).astype(jnp.int32)
    return jnp.where(valid, w, -1)


def bow_vector(cfg: SlamConfig, vocab, desc, valid, idf=None):
    """Public L2-normalized BoW tf-idf vector of a descriptor set.

    ``idf=None`` falls back to uniform weights (pre-training callers)."""
    if idf is None:
        idf = jnp.ones((cfg.loop.vocab_size,))
    return _bow_vector(cfg, vocab, idf, desc, valid)


@functools.partial(jax.jit, static_argnums=(0,))
def compute_bow(cfg: SlamConfig, loop: LoopState, map_state, kf_id) -> LoopState:
    """Compute + store the BoW vector of one keyframe (on insertion)."""
    bow = _bow_vector(
        cfg, loop.vocab, loop.idf,
        map_state.kf_desc[kf_id], map_state.kf_kp_valid[kf_id],
    )
    bow = jnp.where(loop.vocab_ready, bow, 0.0)
    return loop._replace(kf_bow=loop.kf_bow.at[kf_id].set(bow))
