"""GraphSAGE (mean aggregator).

Math parity with the reference trainer's DGL stack
(training_backend/legion_graphsage.py:37-64, dgl.nn.SAGEConv 'mean'):

    h_N(v)  = mean_{(u->v) in block} h_u
    h'_v    = W_self h_v + b + W_neigh h_N(v)
    between layers: ReLU + dropout

Aggregation uses the sampler's reversed edges (src = sampled neighbor,
dst = center, operator_impl.cu:256-257), so a plain masked segment-mean over
dst is exactly the neighbor mean.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from legion_tpu.config import SamplerConfig
from legion_tpu.models.common import dropout, static_cum_sizes, \
    xavier_uniform
from legion_tpu.ops.hop_agg import hop_neighbor_mean
from legion_tpu.sampling import SampleBatch


def sage_layer_apply(params, h_src: jax.Array, edge_src: jax.Array,
                     fanout: int, hop_offset: jax.Array, num_dst: int,
                     aligned_offset=None) -> jax.Array:
    """One SAGEConv(mean) layer. h_src: [N_src, d_in] -> [num_dst, d_out].

    Neighbor mean uses the scatter-free dense hop aggregation
    (ops/hop_agg.py) enabled by the sampler's structured edge layout.

    When the layer SHRINKS rows (d_in > d_out) and the hop needs a real
    per-edge gather, the linear W_neigh projection commutes with the mean:
    project h_src first, then gather/mean d_out-wide rows — the per-edge
    row gather and its backward scatter-add move d_out/d_in of the bytes.
    Math is identical: mean(h W) == mean(h) W.
    """
    h_dst = h_src[:num_dst]
    d_in, d_out = params["w_neigh"].shape
    # project to a width PADDED up to 128 columns: the per-edge gather and
    # its backward scatter-add move whole rows, so a 47-class head
    # projects to 128 zero-padded columns, not 256 (narrow rows are kept
    # at 128 for aligned row reads; not measured on the GPU yet). Zero pad
    # columns contribute nothing; the slice after the mean restores d_out.
    dp = max(-(-d_out // 128) * 128, 128)
    if aligned_offset is None and d_in > dp:
        wn = params["w_neigh"]
        if dp != d_out:
            wn = jnp.pad(wn, ((0, 0), (0, dp - d_out)))
        hp = (h_src @ wn).astype(h_src.dtype)
        h_neigh = hop_neighbor_mean(hp, edge_src, fanout, hop_offset,
                                    num_dst, aligned_offset)
        if dp != d_out:
            h_neigh = h_neigh[:, :d_out]
        out = h_dst @ params["w_self"] + h_neigh
    else:
        h_neigh = hop_neighbor_mean(h_src, edge_src, fanout, hop_offset,
                                    num_dst, aligned_offset)
        out = h_dst @ params["w_self"] + h_neigh @ params["w_neigh"]
    return out + params["b"]


class GraphSAGE:
    def __init__(self, sampler_cfg: SamplerConfig, in_dim: int,
                 hidden_dim: int, num_classes: int, dropout: float = 0.5,
                 num_layers: Optional[int] = None,
                 compute_dtype: Optional[str] = None,
                 in_dim_pad: Optional[int] = None):
        self.cfg = sampler_cfg
        self.cdt = jnp.bfloat16 if compute_dtype == "bfloat16" else None
        self.num_layers = num_layers or sampler_cfg.num_hops
        assert self.num_layers == sampler_cfg.num_hops, (
            "layer count must match sampling hops")
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
            k1, k2, key = jax.random.split(key, 3)
            d_in, d_out = self.dims[i], self.dims[i + 1]
            # DGL SAGEConv reset_parameters: xavier_uniform gain=sqrt(2);
            # layer 0's pad rows (feature-table lane padding) are zero
            logical = self.in_dim if i == 0 else d_in
            layers.append({
                "w_self": xavier_uniform_padded(k1, logical, d_in,
                                                (d_out,), gain=2 ** 0.5),
                "w_neigh": xavier_uniform_padded(k2, logical, d_in,
                                                 (d_out,), gain=2 ** 0.5),
                "b": jnp.zeros((d_out,), jnp.float32),
            })
        return {"layers": layers}

    def apply(self, params, feats: jax.Array, batch: SampleBatch,
              train: bool = False, rng: Optional[jax.Array] = None
              ) -> jax.Array:
        """feats: [max_ids, in_dim] -> per-seed logits [batch, classes]."""
        L = self.num_layers
        h = feats
        for i in range(L):
            k = L - 1 - i  # layer i aggregates hop k's edges
            h = sage_layer_apply(params["layers"][i], h[:self.S[k + 1]],
                                 batch.edge_src[k], self.cfg.fanouts[k],
                                 batch.hop_offsets[k], self.S[k],
                                 self.cfg.aligned_hop_offset(k))
            if i != L - 1:
                h = jax.nn.relu(h)
                if self.cdt is not None:
                    # bf16 activations between layers: the next layer's
                    # per-edge row gather and its scatter-add transpose
                    # move half the bytes; aggregation re-accumulates f32.
                    # Cast BEFORE dropout so the mask apply also moves
                    # half the bytes (dropout zeros/scales identically).
                    h = h.astype(self.cdt)
                if rng is not None:
                    rng, sub = jax.random.split(rng)
                    h = dropout(h, self.dropout_rate, sub, train)
        return h[:self.cfg.batch_size]
