"""Model math parity tests: each model's output is checked allclose against
the independent NumPy implementation of the reference formulas in
tests/reference_models.py (DGL SAGEConv/GraphConv/GATConv semantics per
legion_{graphsage,gcn,gat}.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legion_tpu.config import SamplerConfig
from legion_tpu.models import GAT, GCN, GraphSAGE, LinkPredSAGE
from legion_tpu.models.common import static_cum_sizes
from legion_tpu.sampling import NeighborSampler
from reference_models import gat_forward, gcn_forward, sage_forward, \
    to_numpy


@pytest.fixture(scope="module")
def sampled(small_dataset):
    ds = small_dataset
    cfg = SamplerConfig(fanouts=(3, 2), batch_size=18)
    csr = ds.graph.to_device()
    sampler = NeighborSampler(cfg, ds.meta.num_nodes)
    seeds = jnp.asarray(ds.train_ids[:18], dtype=jnp.int32)
    batch, _ = sampler.sample(csr, seeds, sampler.init_state(),
                              jax.random.PRNGKey(42))
    batch = jax.device_get(batch)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (cfg.max_ids, 12)).astype(np.float32)
    return ds, cfg, batch, feats


def test_sage_parity(sampled):
    ds, cfg, batch, feats = sampled
    model = GraphSAGE(cfg, in_dim=12, hidden_dim=8, num_classes=5)
    params = model.init(jax.random.PRNGKey(1))
    logits = np.asarray(model.apply(params, jnp.asarray(feats), batch))
    ref = sage_forward(to_numpy(params), feats, batch.edge_src,
                       batch.edge_dst, static_cum_sizes(cfg), cfg.batch_size)
    np.testing.assert_allclose(logits, ref, rtol=2e-5, atol=2e-5)


def test_gcn_parity(sampled):
    ds, cfg, batch, feats = sampled
    model = GCN(cfg, in_dim=12, hidden_dim=8, num_classes=5)
    params = model.init(jax.random.PRNGKey(2))
    logits = np.asarray(model.apply(params, jnp.asarray(feats), batch))
    ref = gcn_forward(to_numpy(params), feats, batch.edge_src,
                      batch.edge_dst, static_cum_sizes(cfg), cfg.batch_size)
    np.testing.assert_allclose(logits, ref, rtol=2e-5, atol=2e-5)


def test_gat_chunked_attention_matches_dense(sampled):
    """The fanout-chunked attention scan (the memory-bounded path that
    replaces the [fanout, F, H, d] materialization at products-scale GAT)
    must match the dense path exactly."""
    from legion_tpu.ops import hop_agg
    ds, cfg, batch, feats = sampled
    model = GAT(cfg, in_dim=12, hidden_dim=4, num_classes=5, heads=(2, 1),
                feat_drop=0.0, attn_drop=0.0)
    params = model.init(jax.random.PRNGKey(3))
    dense = np.asarray(model.apply(params, jnp.asarray(feats), batch))
    orig = hop_agg._ATTN_DENSE_LIMIT
    try:
        hop_agg._ATTN_DENSE_LIMIT = 0      # force the scan path
        chunked = np.asarray(model.apply(params, jnp.asarray(feats),
                                         batch))
    finally:
        hop_agg._ATTN_DENSE_LIMIT = orig
    np.testing.assert_allclose(dense, chunked, rtol=2e-5, atol=2e-5)


def test_gat_parity(sampled):
    ds, cfg, batch, feats = sampled
    model = GAT(cfg, in_dim=12, hidden_dim=4, num_classes=5, heads=(2, 1),
                feat_drop=0.0, attn_drop=0.0)
    params = model.init(jax.random.PRNGKey(3))
    logits = np.asarray(model.apply(params, jnp.asarray(feats), batch))
    ref = gat_forward(to_numpy(params), feats, batch.edge_src,
                      batch.edge_dst, static_cum_sizes(cfg), cfg.batch_size)
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-4)


def test_lp_sage_loss_and_grad(sampled):
    ds, cfg_old, batch, feats = sampled
    cfg = SamplerConfig(fanouts=(3, 2), batch_size=18)  # 18 % 3 == 0
    model = LinkPredSAGE(cfg, in_dim=12, hidden_dim=8)
    params = model.init(jax.random.PRNGKey(4))
    seed_valid = jnp.ones((cfg.batch_size,), bool)
    loss, grads = jax.value_and_grad(model.loss)(
        params, jnp.asarray(feats), batch, seed_valid)
    assert np.isfinite(float(loss))
    gnorm = sum(float(jnp.abs(g).sum())
                for g in jax.tree_util.tree_leaves(grads))
    assert gnorm > 0


def test_dropout_active_in_train_mode(sampled):
    ds, cfg, batch, feats = sampled
    model = GraphSAGE(cfg, in_dim=12, hidden_dim=8, num_classes=5,
                      dropout=0.5)
    params = model.init(jax.random.PRNGKey(5))
    a = model.apply(params, jnp.asarray(feats), batch, train=True,
                    rng=jax.random.PRNGKey(10))
    b = model.apply(params, jnp.asarray(feats), batch, train=True,
                    rng=jax.random.PRNGKey(11))
    c = model.apply(params, jnp.asarray(feats), batch, train=False)
    assert not np.allclose(np.asarray(a), np.asarray(b))
    d = model.apply(params, jnp.asarray(feats), batch, train=False,
                    rng=jax.random.PRNGKey(12))
    np.testing.assert_allclose(np.asarray(c), np.asarray(d))


def test_gcn_degree_normalization_exact_with_bf16_features():
    """Block degrees above 256 must not saturate when features are bf16:
    600 edges from one source into one destination."""
    from legion_tpu.models.gcn import gcn_layer_apply
    fanout, n_src = 600, 4
    p = {"w": jnp.asarray(np.random.default_rng(0).standard_normal(
        (8, 3)), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}
    h = jnp.asarray(np.random.default_rng(1).standard_normal((n_src, 8)),
                    jnp.float32)
    edge_src = jnp.full((fanout,), 2, jnp.int32)    # F = 1 destination
    f32 = gcn_layer_apply(p, h, edge_src, fanout, jnp.int32(0), 1)
    bf = gcn_layer_apply(p, h.astype(jnp.bfloat16), edge_src, fanout,
                         jnp.int32(0), 1)
    ref = gcn_forward({"layers": [to_numpy(p)]}, np.asarray(h),
                      [np.asarray(edge_src)], [np.zeros(fanout, np.int32)],
                      (1, n_src), 1)
    np.testing.assert_allclose(np.asarray(f32), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(bf, np.float32), ref, rtol=2e-2,
                               atol=2e-2)
