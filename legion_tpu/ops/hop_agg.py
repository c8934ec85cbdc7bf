"""Dense per-hop aggregation — scatter-free SpMM for sampled blocks.

The sampler's hop-k edge list is STRUCTURED (sampler.py SampleBatch) and
FANOUT-MAJOR: draw f of frontier slot i occupies lane f * F + i, so its dst
is ``hop_offset + lane % F``. Aggregation by destination therefore reduces
to `fanout` contiguous [F, d] slice-adds — no scatter, no sort, no segment
ids, and no relayout: splitting the LEADING axis of an [E, d] array into
[fanout, F, d] keeps each row contiguous, while the frontier-major
[F, fanout, d] split would need a transpose.

Scatter-adds with duplicate indices need atomics (GPU) or serialise, so
this path avoids them; how it compares with a segment-sum on the GPU is
not measured yet. The generic masked segment ops (ops/segment.py) remain
for edge lists without this structure.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from legion_tpu.ops.segment import gather_rows


def hop_gather_msgs(h_src: jax.Array, src_l: jax.Array, fanout: int,
                    aligned_offset: Optional[int] = None
                    ) -> Tuple[jax.Array, jax.Array]:
    """Gather per-edge messages into [fanout, F, d] + validity [fanout, F].
    src_l: [fanout * F] local indices in fanout-major lane order, -1 pad.

    When the hop is lane-aligned (sampler skipped last-hop dedup, so
    position == aligned_offset + lane), the per-edge row gather — and its
    scatter-add transpose in the backward pass — collapses to a static
    slice."""
    E = src_l.shape[0]
    F = E // fanout
    if aligned_offset is not None:
        msgs = jax.lax.slice(h_src, (aligned_offset, 0),
                             (aligned_offset + E, h_src.shape[1]))
        msgs = msgs.reshape(fanout, F, h_src.shape[1])
    else:
        msgs = gather_rows(h_src, src_l).reshape(fanout, F, h_src.shape[1])
    valid = (src_l >= 0).reshape(fanout, F)
    return msgs, valid


def place_rows(rows: jax.Array, offset: jax.Array, num_dst: int
               ) -> jax.Array:
    """Embed [F, ...] frontier rows at [offset, offset+F) of a zeroed
    [num_dst, ...] buffer."""
    out = jnp.zeros((num_dst,) + rows.shape[1:], rows.dtype)
    offset = jnp.asarray(offset, jnp.int32)
    idx = (offset,) + (jnp.int32(0),) * (rows.ndim - 1)
    return jax.lax.dynamic_update_slice(out, rows, idx)


def hop_neighbor_sum(h_src: jax.Array, src_l: jax.Array, fanout: int,
                     offset: jax.Array, num_dst: int,
                     aligned_offset: Optional[int] = None,
                     ) -> Tuple[jax.Array, jax.Array]:
    """Sum of neighbor features per dst and the neighbor count per dst.
    Returns (sum [num_dst, d], count [num_dst]).

    The reduction is `fanout` masked slice-adds over the leading axis —
    elementwise work that fuses with the feature-gather producer."""
    msgs, valid = hop_gather_msgs(h_src, src_l, fanout, aligned_offset)
    # accumulate in f32 so bf16 feature storage loses no precision
    acc = jnp.float32 if msgs.dtype == jnp.bfloat16 else msgs.dtype
    msum = jnp.sum(jnp.where(valid[..., None], msgs, 0), axis=0, dtype=acc)
    cnt = jnp.sum(valid, axis=0).astype(acc)
    return place_rows(msum, offset, num_dst), \
        place_rows(cnt, offset, num_dst)


def hop_neighbor_mean(h_src: jax.Array, src_l: jax.Array, fanout: int,
                      offset: jax.Array, num_dst: int,
                      aligned_offset: Optional[int] = None) -> jax.Array:
    s, c = hop_neighbor_sum(h_src, src_l, fanout, offset, num_dst,
                            aligned_offset)
    return s / jnp.maximum(c, 1)[:, None]


# above this many edge-message elements (fanout * F * H * d) the dense
# [fanout, F, H, d] materialization is replaced by a fanout-chunked scan:
# the full tensor costs ~8.4GB f32 at products-scale GAT before backward
# temps, while DGL's fused u_mul_e SpMM never materializes it — the scan
# is the XLA equivalent, peaking at one [F, H, d] slice per step. The
# limit was sized for a 16 GB device; an 80 GB card could hold the dense
# form (a perf decision for the benchmark, not made yet).
_ATTN_DENSE_LIMIT = 64 * 1024 * 1024


def hop_softmax_attention(z: jax.Array, scores: jax.Array,
                          src_l: jax.Array, fanout: int, offset: jax.Array,
                          num_dst: int, attn_drop: float = 0.0,
                          train: bool = False,
                          rng: Optional[jax.Array] = None,
                          aligned_offset: Optional[int] = None,
                          dense_limit: Optional[int] = None) -> jax.Array:
    """GAT-style per-dst softmax + weighted sum over the frontier rows.

    z: [N_src, H, d] projected features; scores: [fanout, F, H] edge scores
    (already LeakyReLU'd, fanout-major). Returns [num_dst, H, d].
    """
    from legion_tpu.models.common import dropout
    E = src_l.shape[0]
    F = E // fanout
    H, d = z.shape[1], z.shape[2]
    valid = (src_l >= 0).reshape(fanout, F)
    neg = jnp.asarray(jnp.finfo(scores.dtype).min, scores.dtype)
    s = jnp.where(valid[..., None], scores, neg)
    m = jnp.max(s, axis=0, keepdims=True)
    e = jnp.where(valid[..., None], jnp.exp(s - jax.lax.stop_gradient(m)),
                  0)
    denom = jnp.maximum(jnp.sum(e, axis=0, keepdims=True),
                        jnp.finfo(scores.dtype).tiny)
    alpha = e / denom                                    # [fanout, F, H]
    alpha = dropout(alpha, attn_drop, rng, train)
    z2 = z.reshape(z.shape[0], -1)
    limit = _ATTN_DENSE_LIMIT if dense_limit is None else dense_limit

    if E * H * d <= limit:
        if aligned_offset is not None:
            zs = jax.lax.slice(z2, (aligned_offset, 0),
                               (aligned_offset + E, z2.shape[1]))
        else:
            zs = gather_rows(z2, src_l)
        zs = zs.reshape(fanout, F, H, d)                 # [fo, F, H, d]
        out = jnp.sum(alpha[..., None] * zs, axis=0)     # [F, H, d]
        return place_rows(out, offset, num_dst)

    # fanout-chunked accumulation: invalid lanes carry alpha == 0, so the
    # clipped gather rows they read contribute nothing. The body is
    # rematerialized: without checkpoint the scan saves each chunk's
    # gathered zf for backward — fanout x [F, H*d] residuals re-assemble
    # the full edge-message tensor this chunking exists to avoid.
    @jax.checkpoint
    def body(acc, inputs):
        alpha_f, src_f, f = inputs
        if aligned_offset is not None:
            zf = jax.lax.dynamic_slice(
                z2, (aligned_offset + f * F, 0), (F, z2.shape[1]))
        else:
            zf = gather_rows(z2, src_f)
        acc = acc + alpha_f[..., None] * zf.reshape(F, H, d).astype(
            acc.dtype)
        return acc, None

    # derive the zero init from alpha so its varying-axes type matches the
    # body output under shard_map (scan carries must agree in manual axes)
    acc0 = jnp.zeros((F, H, d), jnp.float32) \
        + alpha.astype(jnp.float32)[0, :, :, None] * 0
    acc, _ = jax.lax.scan(
        body, acc0,
        (alpha.astype(jnp.float32), src_l.reshape(fanout, F),
         jnp.arange(fanout, dtype=jnp.int32)))
    return place_rows(acc.astype(z.dtype), offset, num_dst)
