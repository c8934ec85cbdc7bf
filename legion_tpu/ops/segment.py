"""Masked segment ops — the aggregation primitives for message passing.

These are the XLA equivalents of DGL's SpMM/segment reductions that the
reference's models lean on (training_backend/legion_graphsage.py:37-64 uses
dgl.nn.SAGEConv whose hot path is copy_u/mean). Convention throughout:
segment id -1 == padded/invalid edge, dropped from every reduction (mirrors
the reference's -1 padded id buffers, operator_impl.cu:40-43).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _safe_ids(segment_ids: jax.Array, num_segments: int) -> jax.Array:
    """Map invalid (<0) ids to num_segments so scatter mode='drop' skips."""
    return jnp.where(segment_ids >= 0, segment_ids, num_segments)


def gather_rows(data: jax.Array, idx: jax.Array) -> jax.Array:
    """Row gather tolerant of -1 padding (returns garbage rows for pads —
    callers must drop their contributions via the segment id)."""
    return data[jnp.clip(idx, 0, data.shape[0] - 1)]


def masked_segment_sum(data: jax.Array, segment_ids: jax.Array,
                       num_segments: int) -> jax.Array:
    out = jnp.zeros((num_segments,) + data.shape[1:], dtype=data.dtype)
    return out.at[_safe_ids(segment_ids, num_segments)].add(
        data, mode="drop")


def masked_segment_mean(data: jax.Array, segment_ids: jax.Array,
                        num_segments: int) -> jax.Array:
    s = masked_segment_sum(data, segment_ids, num_segments)
    ones = jnp.ones(segment_ids.shape, dtype=data.dtype)
    cnt = masked_segment_sum(ones, segment_ids, num_segments)
    cnt = jnp.maximum(cnt, 1)
    return s / cnt.reshape((num_segments,) + (1,) * (data.ndim - 1))


def masked_segment_max(data: jax.Array, segment_ids: jax.Array,
                       num_segments: int,
                       initial: Optional[float] = None) -> jax.Array:
    if initial is None:
        initial = jnp.finfo(data.dtype).min if jnp.issubdtype(
            data.dtype, jnp.floating) else jnp.iinfo(data.dtype).min
    out = jnp.full((num_segments,) + data.shape[1:], initial,
                   dtype=data.dtype)
    return out.at[_safe_ids(segment_ids, num_segments)].max(
        data, mode="drop")


def segment_softmax(scores: jax.Array, segment_ids: jax.Array,
                    num_segments: int) -> jax.Array:
    """Numerically stable softmax within segments (GAT attention,
    reference: DGL edge_softmax inside GATConv, legion_gat.py:37-79).

    scores: [E] or [E, H]; invalid edges get weight 0.
    """
    valid = segment_ids >= 0
    # zero-floored max: still a constant shift per segment (softmax
    # invariant), never the finfo.min sentinel of empty segments, and keeps
    # exp() <= 1 for positive scores. Masking BEFORE exp matters: an exp(inf)
    # on an invalid lane would poison the backward pass even under where().
    m = jnp.maximum(masked_segment_max(scores, segment_ids, num_segments), 0)
    vshape = valid.reshape(valid.shape + (1,) * (scores.ndim - 1))
    shifted = jnp.where(vshape, scores - gather_rows(m, segment_ids), 0)
    e = jnp.where(vshape, jnp.exp(shifted), 0)
    denom = masked_segment_sum(e, segment_ids, num_segments)
    denom = jnp.maximum(denom, jnp.finfo(scores.dtype).tiny)
    return e / gather_rows(denom, segment_ids)
