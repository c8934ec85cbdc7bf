"""Shared model utilities: block geometry, initializers, dropout.

Models are plain pytree params + pure apply functions (idiomatic JAX — easy
to pjit/shard_map, no framework state). The reference models are DGL/torch
nn.Modules (training_backend/legion_{graphsage,gcn,gat}.py); math parity is
with their per-layer formulas, not their implementation.

Block geometry: layer i (of L) aggregates over hop k = L-1-i's edges; its
input covers node positions [0, S[k+1]) and output [0, S[k]), where
S[k] = batch + sum_{j<k} E_j are the static worst-case cumulative node counts
(the trainer-side analog of reading node_counter[9+k],
ipc_cuda_kernel.cu:196-229).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from legion_tpu.config import SamplerConfig, TrainConfig


def static_cum_sizes(cfg: SamplerConfig) -> Tuple[int, ...]:
    """S[k] = static bound on unique nodes after hop k; S[0]=batch,
    S[L]=max_ids. Tightened by measured node_caps when present (the
    reference's 1.2 x MaxIdNum buffer sizing, server.cu:275-283)."""
    return cfg.cum_sizes()


def xavier_uniform(key: jax.Array, shape: Tuple[int, ...],
                   gain: float = 1.0, dtype=jnp.float32) -> jax.Array:
    """Glorot uniform, matching torch/DGL reset_parameters conventions."""
    fan_in, fan_out = shape[0], shape[1]
    if len(shape) > 2:  # [in, heads, out] attention weights
        fan_out = shape[1] * shape[2]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def xavier_uniform_padded(key: jax.Array, logical_in: int, padded_in: int,
                          shape_tail: Tuple[int, ...], gain: float = 1.0,
                          dtype=jnp.float32) -> jax.Array:
    """Xavier init for a weight whose input dim is PADDED (feature table
    padded to 128-column multiples, TrainConfig.pad_feature_dim): the first
    `logical_in` rows are initialized with the LOGICAL fan-in (exact parity
    with the unpadded model), the pad rows are zero. Pad rows only ever see
    zero activations, so their grads are zero and they stay zero — the
    padded model is bit-identical to the unpadded one."""
    w = xavier_uniform(key, (logical_in,) + shape_tail, gain, dtype)
    if padded_in == logical_in:
        return w
    pad = [(0, padded_in - logical_in)] + [(0, 0)] * len(shape_tail)
    return jnp.pad(w, pad)


def torch_linear_init(key: jax.Array, in_dim: int, out_dim: int,
                      bias: bool = True, dtype=jnp.float32):
    """torch.nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in))."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    w = jax.random.uniform(kw, (in_dim, out_dim), dtype, -bound, bound)
    if not bias:
        return {"w": w}
    b = jax.random.uniform(kb, (out_dim,), dtype, -bound, bound)
    return {"w": w, "b": b}


def dropout(x: jax.Array, rate: float, key: Optional[jax.Array],
            train: bool) -> jax.Array:
    if not train or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    if rate == 0.5 and x.ndim == 2 and x.shape[-1] % 32 == 0:
        # p=1/2 exactly: each RNG bit IS a Bernoulli(1/2) draw — unpack 32
        # masks per generated word instead of one comparison per element
        # (threefry bit generation is the cost of dropout)
        words = jax.random.bits(key, (x.shape[0], x.shape[1] // 32),
                                jnp.uint32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bits = (words[:, :, None] >> shifts[None, None, :]) & 1
        mask = bits.reshape(x.shape) != 0
        return jnp.where(mask, x / keep, 0).astype(x.dtype)
    if x.ndim >= 2 and x.size >= (1 << 20):
        # big activations: compare raw u8 bits against a fixed-point
        # threshold instead of jax.random.bernoulli's uniform-f32 path —
        # 4x fewer threefry words and no full-shape f32/u32 temps (0.8G
        # per dropout at products-scale GAT).
        # keep quantizes to 1/256; dividing by the QUANTIZED keep makes
        # the estimator exactly unbiased at the realized rate.
        kq = min(max(round(keep * 256), 1), 255)
        bits = jax.random.bits(key, x.shape, jnp.uint8)
        return jnp.where(bits < jnp.uint8(kq), x * (256.0 / kq),
                         0).astype(x.dtype)
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0).astype(x.dtype)


def make_model(train_cfg: TrainConfig, sampler_cfg: SamplerConfig,
               in_dim: int, num_classes: int,
               in_dim_pad: Optional[int] = None):
    """Factory mirroring the reference's per-model launcher scripts.
    in_dim_pad: physical width of the feature rows when the table is
    padded to 128-column multiples (TrainConfig.pad_feature_dim)."""
    from legion_tpu.models.graphsage import GraphSAGE
    from legion_tpu.models.gcn import GCN
    from legion_tpu.models.gat import GAT
    from legion_tpu.models.lp_sage import LinkPredSAGE

    name = train_cfg.model.lower()
    if name == "graphsage":
        return GraphSAGE(sampler_cfg, in_dim, train_cfg.hidden_dim,
                         num_classes, dropout=train_cfg.dropout,
                         compute_dtype=train_cfg.compute_dtype,
                         in_dim_pad=in_dim_pad)
    if name == "gcn":
        return GCN(sampler_cfg, in_dim, train_cfg.hidden_dim, num_classes,
                   dropout=train_cfg.dropout, in_dim_pad=in_dim_pad)
    if name == "gat":
        return GAT(sampler_cfg, in_dim, train_cfg.hidden_dim, num_classes,
                   heads=train_cfg.gat_heads,
                   feat_drop=train_cfg.gat_feat_drop,
                   attn_drop=train_cfg.gat_attn_drop,
                   in_dim_pad=in_dim_pad,
                   compute_dtype=train_cfg.compute_dtype)
    if name == "lp_sage":
        return LinkPredSAGE(sampler_cfg, in_dim, train_cfg.hidden_dim,
                            dropout=train_cfg.dropout,
                            in_dim_pad=in_dim_pad)
    raise ValueError(f"unknown model {train_cfg.model!r}")
