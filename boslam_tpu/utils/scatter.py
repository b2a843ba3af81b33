"""Scatters whose result does not depend on the order updates land in.

XLA:GPU lowers a scatter to parallel (atomic) updates.  Where two updates
hit one index, ``.at[].set`` keeps whichever lands last and a float
``.at[].add`` sums in arrival order, so two runs over the same input can
differ.  These helpers fix the order: ``set_last`` gives the result of a
sequential scatter (the last update in index order wins), and
``segment_sum`` sums each segment in a fixed tree order, the same on every
backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def set_last(arr, idx, vals):
    """``arr.at[idx].set(vals, mode="drop")`` over 1-D ``idx`` where, among
    updates to one index, the last in ``idx`` order wins.  Indices outside
    ``[0, len(arr))`` are dropped."""
    n = arr.shape[0]
    lane = jnp.arange(idx.shape[0], dtype=jnp.int32)
    inb = (idx >= 0) & (idx < n)
    tgt = jnp.where(inb, idx, n)
    # Integer max is order-independent, so the winning lane is too.
    win = jnp.full((n,), -1, jnp.int32).at[tgt].max(lane, mode="drop")
    keep = inb & (win[jnp.clip(idx, 0, n - 1)] == lane)
    return arr.at[jnp.where(keep, idx, n)].set(vals, mode="drop")


def segment_sum(data, segment_ids, num_segments: int):
    """``jax.ops.segment_sum`` with a fixed summation order: a stable sort
    by segment, a segmented scan, and one scatter of each segment's total
    (one update per index).  Ids outside ``[0, num_segments)`` are
    dropped."""
    ids = jnp.where(
        (segment_ids >= 0) & (segment_ids < num_segments),
        segment_ids, num_segments,
    )
    order = jnp.argsort(ids, stable=True)
    seg = ids[order]
    x = data[order]
    change = seg[1:] != seg[:-1]
    start = jnp.concatenate([jnp.ones((1,), bool), change])
    last = jnp.concatenate([change, jnp.ones((1,), bool)])

    def combine(a, b):
        xa, sa = a
        xb, sb = b
        sel = sb.reshape(sb.shape + (1,) * (xb.ndim - sb.ndim))
        return jnp.where(sel, xb, xa + xb), sa | sb

    total, _ = jax.lax.associative_scan(combine, (x, start))
    out = jnp.zeros((num_segments,) + data.shape[1:], data.dtype)
    return out.at[jnp.where(last, seg, num_segments)].set(total, mode="drop")
