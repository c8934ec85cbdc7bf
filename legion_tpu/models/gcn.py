"""GCN with symmetric degree normalization.

Math parity with the reference trainer's DGL GraphConv(norm='both',
allow_zero_in_degree=True) stack (training_backend/legion_gcn.py:68-96):

    h'_v = b + sum_{(u->v)} ( d_out(u)^{-1/2} h_u ) W * d_in(v)^{-1/2}

Degrees are block-local (counted over the sampled edges, like DGL computes
them on the block graph); zero in-degree vertices get a zero neighbor term.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from legion_tpu.config import SamplerConfig
from legion_tpu.models.common import dropout, static_cum_sizes, \
    xavier_uniform
from legion_tpu.ops import masked_segment_sum
from legion_tpu.ops.hop_agg import hop_neighbor_sum
from legion_tpu.sampling import SampleBatch


def gcn_layer_apply(params, h_src: jax.Array, edge_src: jax.Array,
                    fanout: int, hop_offset: jax.Array, num_dst: int,
                    aligned_offset=None) -> jax.Array:
    n_src = h_src.shape[0]
    valid = edge_src >= 0
    # degrees count in float32 whatever the feature dtype: a bf16 sum of
    # ones stops growing at 256, which mis-normalizes every hub
    if aligned_offset is not None:
        # lane-aligned hop: each src slot carries exactly its own lane's
        # edge, so the block-local out-degree is the validity indicator —
        # no segment scatter needed. NOTE: a node drawn m times counts as
        # m degree-1 slots here, vs one degree-m node in a deduped block
        # (DGL norm='both' on the reference's blocks). For exact GCN
        # normalization parity keep dedup_last_hop=True; SAGE/GAT/lp_sage
        # are invariant either way (per-dst mean/softmax over the same
        # multiset).
        window = jnp.zeros((n_src,), jnp.float32).at[
            aligned_offset:aligned_offset + edge_src.shape[0]].set(
            valid.astype(jnp.float32))
        inv_sqrt_out = window
    else:
        ones = jnp.ones(edge_src.shape, dtype=jnp.float32)
        # block-local out-degree needs a true segment-sum (src order is
        # unstructured); in-degree falls out of the dense hop aggregation
        out_deg = masked_segment_sum(ones, jnp.where(valid, edge_src, -1),
                                     n_src)
        inv_sqrt_out = jnp.where(out_deg > 0, jax.lax.rsqrt(
            jnp.maximum(out_deg, 1)), 0)

    d_in, d_out = params["w"].shape
    if d_in > d_out:
        # project first when it shrinks rows (DGL GraphConv ordering)
        h_msg = (h_src @ params["w"]) * inv_sqrt_out[:, None]
        agg, in_deg = hop_neighbor_sum(h_msg, edge_src, fanout, hop_offset,
                                       num_dst, aligned_offset)
    else:
        h_msg = h_src * inv_sqrt_out[:, None].astype(h_src.dtype)
        agg, in_deg = hop_neighbor_sum(h_msg, edge_src, fanout, hop_offset,
                                       num_dst, aligned_offset)
        agg = agg @ params["w"]
    inv_sqrt_in = jnp.where(in_deg > 0, jax.lax.rsqrt(
        jnp.maximum(in_deg, 1)), 0)
    out = agg * inv_sqrt_in[:, None]
    return out + params["b"]


class GCN:
    def __init__(self, sampler_cfg: SamplerConfig, in_dim: int,
                 hidden_dim: int, num_classes: int, dropout: float = 0.5,
                 in_dim_pad=None):
        if sampler_cfg.aligned_hop_offset(sampler_cfg.num_hops - 1) \
                is not None:
            import warnings
            warnings.warn(
                "GCN with dedup_last_hop=False changes norm='both' "
                "semantics: a node drawn m times counts as m degree-1 "
                "slots instead of one degree-m node. Set "
                "SamplerConfig(dedup_last_hop=True) for exact parity "
                "with the reference's DGL blocks (legion_gcn.py:68-96).",
                stacklevel=2)
        self.cfg = sampler_cfg
        self.num_layers = sampler_cfg.num_hops
        self.in_dim = in_dim
        self.in_dim_pad = in_dim_pad or in_dim
        self.dims = ([self.in_dim_pad] + [hidden_dim]
                     * (self.num_layers - 1) + [num_classes])
        self.dropout_rate = dropout
        self.S = static_cum_sizes(sampler_cfg)

    def init(self, key: jax.Array):
        from legion_tpu.models.common import xavier_uniform_padded
        layers = []
        for i in range(self.num_layers):
            k1, key = jax.random.split(key)
            logical = self.in_dim if i == 0 else self.dims[i]
            # DGL GraphConv reset_parameters: xavier_uniform, zero bias
            layers.append({
                "w": xavier_uniform_padded(k1, logical, self.dims[i],
                                           (self.dims[i + 1],)),
                "b": jnp.zeros((self.dims[i + 1],), jnp.float32),
            })
        return {"layers": layers}

    def apply(self, params, feats: jax.Array, batch: SampleBatch,
              train: bool = False, rng: Optional[jax.Array] = None
              ) -> jax.Array:
        L = self.num_layers
        h = feats
        for i in range(L):
            k = L - 1 - i
            h = gcn_layer_apply(params["layers"][i], h[:self.S[k + 1]],
                                batch.edge_src[k], self.cfg.fanouts[k],
                                batch.hop_offsets[k], self.S[k],
                                self.cfg.aligned_hop_offset(k))
            if i != L - 1:
                h = jax.nn.relu(h)
                if rng is not None:
                    rng, sub = jax.random.split(rng)
                    h = dropout(h, self.dropout_rate, sub, train)
        return h[:self.cfg.batch_size]
