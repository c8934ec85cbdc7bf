"""GAT with edge-wise SDDMM attention.

Math parity with the reference trainer's DGL GATConv stack
(training_backend/legion_gat.py:37-79; heads [8,1], feat/attn dropout 0.6,
mid layers flatten heads, last layer means them):

    z_u     = W h_u                       (per head)
    e_uv    = LeakyReLU(a_l . z_u + a_r . z_v)      # SDDMM over edges
    alpha   = segment_softmax(e, dst)                # per-dst normalization
    h'_v    = sum_u alpha_uv z_u
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from legion_tpu.config import SamplerConfig
from legion_tpu.models.common import dropout, static_cum_sizes, \
    xavier_uniform
from legion_tpu.ops import gather_rows
from legion_tpu.ops.hop_agg import hop_softmax_attention, place_rows
from legion_tpu.sampling import SampleBatch


def gat_layer_aligned_streaming(params, h_src: jax.Array,
                                edge_src: jax.Array, fanout: int,
                                hop_offset: jax.Array, num_dst: int,
                                aligned_offset: int,
                                negative_slope: float = 0.2,
                                attn_drop: float = 0.0,
                                train: bool = False,
                                rng: Optional[jax.Array] = None,
                                compute_dtype=None) -> jax.Array:
    """Multi-head GATConv for a LANE-ALIGNED hop via the projection
    commute.

    Both halves of GAT attention commute with the per-head linear map:

        scores:  e_l = z . a_l = (x W_h) . a_l = x . (W_h a_l)
        output:  sum_f alpha_f (x_f W_h)       = (sum_f alpha_f x_f) W_h

    so the [E, heads*hidden] projected tensor z — 4.2GB bf16 at products
    scale, with per-edge 4KB-row gathers and backward scatter-adds —
    NEVER EXISTS. The layer is three skinny matrix contractions over the
    raw d_in-wide lanes (static slices, lane-aligned):
    scores [E, d_in] @ [d_in, H], the fanout-contraction
    alpha[f,i,h] x[f,i,k] -> xw[i,h,k], and xw @ W per head. x is a leaf
    (layer 0), so backward has no scatter anywhere.

    Note on feat_drop semantics: in aligned mode input dropout is applied
    per SLOT (lane), so duplicate draws of one node carry independent
    masks — an unbiased variant of DGL's per-node mask (reference applies
    dropout to the deduped block's rows, legion_gat.py:48).
    """
    H, d_out = params["attn_l"].shape
    E = edge_src.shape[0]
    F = E // fanout
    d_in = h_src.shape[1]
    w = params["w"].reshape(d_in, H, d_out)
    al, ar = params["attn_l"], params["attn_r"]
    if compute_dtype is not None:
        w = w.astype(compute_dtype)
        al = al.astype(compute_dtype)
        ar = ar.astype(compute_dtype)
        h_src = h_src.astype(compute_dtype)
    valid = (edge_src >= 0).reshape(fanout, F)

    # folded attention vectors: u_l[k, h] = sum_d w[k, h, d] a[h, d]
    u_l = jnp.einsum("khd,hd->kh", w, al)               # [d_in, H]
    u_r = jnp.einsum("khd,hd->kh", w, ar)

    x_dst = jax.lax.dynamic_slice(
        h_src, (jnp.asarray(hop_offset, jnp.int32), jnp.int32(0)),
        (F, d_in))
    x_lanes = jax.lax.dynamic_slice(
        h_src, (jnp.int32(aligned_offset), jnp.int32(0)), (E, d_in))

    er = (x_dst @ u_r).astype(jnp.float32)              # [F, H]
    el = (x_lanes @ u_l).astype(jnp.float32).reshape(fanout, F, H)

    e = jax.nn.leaky_relu(el + er[None], negative_slope)  # [fo, F, H]
    neg = jnp.asarray(jnp.finfo(e.dtype).min, e.dtype)
    s = jnp.where(valid[..., None], e, neg)
    m = jnp.max(s, axis=0, keepdims=True)
    ex = jnp.where(valid[..., None], jnp.exp(s - jax.lax.stop_gradient(m)),
                   0)
    denom = jnp.maximum(jnp.sum(ex, axis=0, keepdims=True),
                        jnp.finfo(e.dtype).tiny)
    alpha = dropout(ex / denom, attn_drop, rng, train)    # [fo, F, H]

    # alpha-weighted feature mix BEFORE projecting: contract fanout
    xw = jnp.einsum("fih,fik->ihk",
                    alpha.astype(x_lanes.dtype),
                    x_lanes.reshape(fanout, F, d_in))     # [F, H, d_in]
    acc = jnp.einsum("ihk,khd->ihd", xw, w,
                     preferred_element_type=jnp.float32)  # [F, H, d_out]
    out = place_rows(acc.astype(h_src.dtype), hop_offset, num_dst)
    return out + params["b"][None]


def gat_layer_apply(params, h_src: jax.Array, edge_src: jax.Array,
                    fanout: int, hop_offset: jax.Array, num_dst: int,
                    negative_slope: float = 0.2,
                    attn_drop: float = 0.0, train: bool = False,
                    rng: Optional[jax.Array] = None,
                    aligned_offset=None, compute_dtype=None) -> jax.Array:
    """One multi-head GATConv. Returns [num_dst, heads, d_out].

    The SDDMM scores and the per-dst softmax run densely per frontier row
    ([F, fanout, H]) thanks to the sampler's structured edge layout.

    compute_dtype=bfloat16 keeps the projected features z in bf16: at
    products-scale the layer-0 z is [~480k, 8 x 256] — 3.95G in f32
    before its backward temps. Scores/softmax/aggregation still
    accumulate f32.
    """
    H, d_out = params["attn_l"].shape
    w = params["w"].reshape(h_src.shape[1], H * d_out)
    al, ar = params["attn_l"], params["attn_r"]
    if compute_dtype is not None:
        # cast the WEIGHTS, not the product: h_src(bf16) @ w(f32) would
        # materialize the full f32 [N_src, H*d] projection before any
        # cast (3.68G at products scale), and z * attn(f32) broadcasts
        # another one. bf16 x bf16 dots still accumulate f32;
        # the attention score sums accumulate f32 explicitly below.
        w = w.astype(compute_dtype)
        al = al.astype(compute_dtype)
        ar = ar.astype(compute_dtype)
        h_src = h_src.astype(compute_dtype)
    z = (h_src @ w).reshape(-1, H, d_out)
    el = jnp.sum(z * al[None], axis=-1, dtype=jnp.float32)  # [N_src, H]
    er = jnp.sum(z * ar[None], axis=-1, dtype=jnp.float32)
    F = edge_src.shape[0] // fanout
    # fanout-major lanes: dst of lane f*F + i is frontier row i at
    # position hop_offset + i
    er_dst = jax.lax.dynamic_slice(
        er, (jnp.asarray(hop_offset, jnp.int32), jnp.int32(0)), (F, H))
    if aligned_offset is not None:
        el_e = jax.lax.slice(el, (aligned_offset, 0),
                             (aligned_offset + edge_src.shape[0], H))
    else:
        el_e = gather_rows(el, edge_src)
    e = el_e.reshape(fanout, F, H) + er_dst[None, :]
    e = jax.nn.leaky_relu(e, negative_slope)
    out = hop_softmax_attention(z, e, edge_src, fanout, hop_offset,
                                num_dst, attn_drop, train, rng,
                                aligned_offset)
    return out + params["b"][None]


class GAT:
    def __init__(self, sampler_cfg: SamplerConfig, in_dim: int,
                 hidden_dim: int, num_classes: int,
                 heads: Sequence[int] = (8, 1), feat_drop: float = 0.6,
                 attn_drop: float = 0.6, negative_slope: float = 0.2,
                 in_dim_pad=None, compute_dtype: Optional[str] = None):
        self.cdt = jnp.bfloat16 if compute_dtype == "bfloat16" else None
        self.cfg = sampler_cfg
        self.num_layers = sampler_cfg.num_hops
        assert len(heads) == self.num_layers
        self.heads = tuple(heads)
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.S = static_cum_sizes(sampler_cfg)
        self.in_dim = in_dim
        self.in_dim_pad = in_dim_pad or in_dim
        # layer i: in = in_dim (i=0) else hidden*heads[i-1] (flattened);
        # out-per-head = hidden for mid layers, num_classes for the last
        self.layer_in = [self.in_dim_pad] + [hidden_dim * heads[i - 1]
                                             for i in range(1,
                                                            self.num_layers)]
        self.layer_out = [hidden_dim] * (self.num_layers - 1) + [num_classes]

    def init(self, key: jax.Array):
        from legion_tpu.models.common import xavier_uniform_padded
        layers = []
        for i in range(self.num_layers):
            k1, k2, k3, key = jax.random.split(key, 4)
            d_in, d_out, H = self.layer_in[i], self.layer_out[i], \
                self.heads[i]
            logical = self.in_dim if i == 0 else d_in
            layers.append({
                # DGL GATConv reset_parameters: xavier gain=sqrt(2)
                "w": xavier_uniform_padded(k1, logical, d_in, (H, d_out),
                                           gain=2 ** 0.5),
                "attn_l": xavier_uniform(k2, (H, d_out), gain=2 ** 0.5),
                "attn_r": xavier_uniform(k3, (H, d_out), gain=2 ** 0.5),
                "b": jnp.zeros((H, d_out), jnp.float32),
            })
        return {"layers": layers}

    def apply(self, params, feats: jax.Array, batch: SampleBatch,
              train: bool = False, rng: Optional[jax.Array] = None
              ) -> jax.Array:
        L = self.num_layers
        h = feats
        for i in range(L):
            k = L - 1 - i
            if rng is not None:
                rng, kf, ka = jax.random.split(rng, 3)
            else:
                kf = ka = None
            h = dropout(h, self.feat_drop, kf, train)
            ao = self.cfg.aligned_hop_offset(k)
            if ao is not None:
                # lane-aligned hop: the projection-commute layer — static
                # slices, no z materialization, no gathers/scatters
                out = gat_layer_aligned_streaming(
                    params["layers"][i], h[:self.S[k + 1]],
                    batch.edge_src[k], self.cfg.fanouts[k],
                    batch.hop_offsets[k], self.S[k], ao,
                    self.negative_slope, self.attn_drop, train, ka,
                    self.cdt)
            else:
                layer = gat_layer_apply
                if i == 0 and self.cdt is not None:
                    # remat the widest layer (z is [S[L], heads*hidden] —
                    # ~2G bf16 at products scale): recompute it in
                    # backward instead of keeping it resident alongside
                    # its gradient. compute_dtype passed POSITIONALLY:
                    # static_argnums counts positional args only.
                    layer = jax.checkpoint(
                        gat_layer_apply,
                        static_argnums=(3, 5, 6, 7, 8, 10, 11))
                out = layer(params["layers"][i], h[:self.S[k + 1]],
                            batch.edge_src[k], self.cfg.fanouts[k],
                            batch.hop_offsets[k],
                            self.S[k], self.negative_slope,
                            self.attn_drop, train, ka, None, self.cdt)
            if i != L - 1:
                # flatten heads + ELU like legion_gat.py:57-60
                out = jax.nn.elu(out.reshape(out.shape[0], -1))
                if self.cdt is not None:
                    out = out.astype(self.cdt)
            else:
                out = out.mean(axis=1)
            h = out
        return h[:self.cfg.batch_size]
