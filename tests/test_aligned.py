"""Lane-aligned last hop (SamplerConfig.dedup_last_hop=False).

The lane-aligned sampling mode skips dedup on the last hop: each candidate lane
becomes its own local slot at position P_last + lane. These tests pin the
layout contract and prove the training math is unchanged vs the exact
(deduped) reference semantics — per-dst mean (SAGE) and per-dst softmax
(GAT) aggregate the same multiset either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legion_tpu.config import SamplerConfig
from legion_tpu.models import GAT, GraphSAGE
from legion_tpu.sampling import NeighborSampler

INT32_MAX = np.iinfo(np.int32).max


def _sample(ds, cfg, seed=0):
    csr = ds.graph.to_device()
    sampler = NeighborSampler(cfg, ds.meta.num_nodes)
    seeds = jnp.asarray(ds.train_ids[:cfg.batch_size], dtype=jnp.int32)
    batch, _ = sampler.sample(csr, seeds, sampler.init_state(),
                              jax.random.PRNGKey(seed))
    return jax.device_get(batch), sampler


@pytest.fixture(scope="module", params=["map", "sort"])
def pair(request, small_dataset):
    ds = small_dataset
    kw = dict(fanouts=(5, 3), batch_size=32, dedup=request.param)
    exact = SamplerConfig(dedup_last_hop=True, **kw)
    fast = SamplerConfig(dedup_last_hop=False, **kw)
    be, se = _sample(ds, exact)
    bf, sf = _sample(ds, fast)
    return ds, exact, fast, be, bf, se, sf


def test_aligned_layout(pair):
    ds, exact, fast, be, bf, se, sf = pair
    L = fast.num_hops
    P = fast.cum_sizes()[L - 1]
    E_last = sf.edge_sizes[L - 1]
    src = bf.edge_src[L - 1]
    lane = np.arange(E_last, dtype=np.int32)
    valid = src >= 0
    # positions are exactly P + lane on valid lanes
    assert np.all(src[valid] == P + lane[valid])
    # ids block mirrors the candidates: ids[P + lane] is the drawn
    # neighbor for every valid lane, -1 elsewhere in the block
    blk = bf.node_ids[P:P + E_last]
    assert np.all((blk >= 0) == valid)
    # total slots bound
    assert sf.max_ids == P + E_last


def test_aligned_same_candidates_as_exact(pair):
    """Same key => identical multiset of drawn neighbors per frontier
    lane; the aligned block IS the candidate array."""
    ds, exact, fast, be, bf, se, sf = pair
    L = fast.num_hops
    P = fast.cum_sizes()[L - 1]
    E_last = sf.edge_sizes[L - 1]
    blk = bf.node_ids[P:P + E_last]
    # reconstruct exact-mode candidates from its src_l -> global ids
    src_e = be.edge_src[L - 1][:E_last]
    cand_e = np.where(src_e >= 0, be.node_ids[np.clip(src_e, 0, None)], -1)
    assert np.array_equal(blk, cand_e)


def test_aligned_valid_count(pair):
    ds, exact, fast, be, bf, se, sf = pair
    L = fast.num_hops
    E_last = sf.edge_sizes[L - 1]
    P = fast.cum_sizes()[L - 1]
    blk = bf.node_ids[P:P + E_last]
    n_prev = int(bf.num_nodes[L - 1])
    assert int(bf.num_nodes[L]) == n_prev + int((blk >= 0).sum())


@pytest.mark.parametrize("model_cls", [GraphSAGE, GAT])
def test_model_math_invariant(pair, model_cls):
    """Forward logits agree between exact and aligned sampling (same key
    => same draws; mean/softmax over the same multiset)."""
    ds, exact, fast, be, bf, se, sf = pair
    feats = jnp.asarray(ds.features[:ds.meta.num_nodes], jnp.float32)

    def run(cfg, batch, sampler):
        if model_cls is GAT:
            m = model_cls(cfg, ds.meta.feature_dim, 16, ds.meta.num_classes,
                          heads=(2, 1), feat_drop=0.0, attn_drop=0.0)
        else:
            m = model_cls(cfg, ds.meta.feature_dim, 16, ds.meta.num_classes,
                          dropout=0.0)
        params = m.init(jax.random.PRNGKey(1))
        ids = jnp.asarray(batch.node_ids)
        x = feats[jnp.clip(ids, 0, ds.meta.num_nodes - 1)]
        x = jnp.where((ids >= 0)[:, None], x, 0)
        batch_dev = jax.tree_util.tree_map(jnp.asarray, batch)
        return np.asarray(m.apply(params, x, batch_dev, train=False))

    le = run(exact, be, se)
    lf = run(fast, bf, sf)
    np.testing.assert_allclose(le, lf, rtol=2e-5, atol=2e-5)
