"""Staged host-feature transfer (CacheConfig.host_transfer="staged").

The staged path splits the fused step into sample/lookup and train
programs with a host gather between them, so only compacted misses cross
to the device. It must be numerically identical to the
callback path: same RNG stream, same assembled feature rows, same losses.
"""

import jax
import numpy as np
import pytest

from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                               SamplerConfig, TrainConfig)
from legion_tpu.pipeline import Mode
from legion_tpu.train import Trainer


def _cfg(ds, transfer):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=64,
                              eval_batch_size=32, dedup="sort"),
        cache=CacheConfig(cache_bytes=200_000, feature_residency="host",
                          presample_steps=2, host_transfer=transfer),
        train=TrainConfig(model="graphsage", hidden_dim=16, epochs=1,
                          seed=3),
        mesh=MeshConfig.for_devices(1),
    )


@pytest.fixture(scope="module")
def trainers(small_dataset):
    ds = small_dataset
    t_cb = Trainer(ds, _cfg(ds, "callback"))
    t_st = Trainer(ds, _cfg(ds, "staged"))
    assert not t_cb._staged_host and t_st._staged_host
    return t_cb, t_st


def test_staged_matches_callback_losses(trainers):
    t_cb, t_st = trainers
    s_cb = t_cb.init_state()
    s_st = t_st.init_state()
    for _ in range(3):
        s_cb, l_cb = t_cb.train_step(s_cb)
        s_st, l_st = t_st.train_step(s_st)
        np.testing.assert_allclose(float(l_cb), float(l_st), rtol=1e-5,
                                   atol=1e-6)


def test_staged_eval_matches_callback(trainers):
    t_cb, t_st = trainers
    s_cb = t_cb.init_state()
    s_st = t_st.init_state()
    s_cb, acc_cb = t_cb.run_eval(s_cb, Mode.VALID)
    s_st, acc_st = t_st.run_eval(s_st, Mode.VALID)
    assert abs(acc_cb - acc_st) < 1e-6, (acc_cb, acc_st)


def test_staged_hits_counted(trainers):
    _, t_st = trainers
    s = t_st.init_state()
    s, _ = t_st.train_step(s)
    hits = int(t_st.last_feat_hits)
    assert 0 < hits <= t_st.sampler_t.max_ids


def test_miss_cap_overflow_drops_tail(small_dataset, monkeypatch):
    """A batch with more misses than the probed cap trains with the tail
    misses dropped (zero feature rows) — no mid-training recompile
    (the reference sizes once from an epoch-wide presample,
    server.cu:275-283)."""
    ds = small_dataset
    monkeypatch.setattr(Trainer, "_probe_miss_cap", lambda self: 8)
    t = Trainer(ds, _cfg(ds, "staged"))
    assert t._miss_cap == 8
    s = t.init_state()
    for _ in range(2):
        s, loss = t.train_step(s)
        assert np.isfinite(float(loss))
    # still exactly one compiled train core — overflow never recompiles
    assert not hasattr(t, "_train_cores")


def _cfg_multidev(ds, transfer, n_dev=4):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=16,
                              eval_batch_size=32, dedup="sort"),
        cache=CacheConfig(cache_bytes=200_000, feature_residency="host",
                          presample_steps=2, host_transfer=transfer),
        train=TrainConfig(model="graphsage", hidden_dim=16, epochs=1,
                          seed=3, compute_dtype="float32"),
        mesh=MeshConfig.for_devices(n_dev, clique_size=n_dev),
    )


def test_staged_multidev_matches_callback(small_dataset):
    """4-member clique, staged transfer: program A runs the clique
    collective lookup (no callbacks), misses cross host->device between
    programs. Must match the callback path's losses exactly."""
    ds = small_dataset
    t_cb = Trainer(ds, _cfg_multidev(ds, "callback"))
    t_st = Trainer(ds, _cfg_multidev(ds, "staged"))
    assert not t_cb._staged_host and t_st._staged_host
    assert t_st._use_clique and t_st._staged_clique
    s_cb = t_cb.init_state()
    s_st = t_st.init_state()
    for _ in range(3):
        s_cb, l_cb = t_cb.train_step(s_cb)
        s_st, l_st = t_st.train_step(s_st)
        np.testing.assert_allclose(float(l_cb), float(l_st), rtol=1e-5,
                                   atol=1e-6)
    assert int(t_st.last_feat_hits) > 0
    s_cb, acc_cb = t_cb.run_eval(s_cb, Mode.VALID)
    s_st, acc_st = t_st.run_eval(s_st, Mode.VALID)
    assert abs(acc_cb - acc_st) < 1e-6, (acc_cb, acc_st)


def _cfg_host_topo(ds, transfer, n_dev=4):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(5, 3), batch_size=16,
                              eval_batch_size=32, dedup="sort",
                              neighbor_window=8),
        cache=CacheConfig(cache_bytes=200_000, feature_residency="host",
                          topo_residency="host", presample_steps=2,
                          host_transfer=transfer),
        train=TrainConfig(model="graphsage", hidden_dim=16, epochs=1,
                          seed=3, compute_dtype="float32"),
        mesh=MeshConfig.for_devices(n_dev, clique_size=n_dev),
    )


def test_staged_multidev_host_topology_matches_callback(small_dataset):
    """The real multi-card billion-edge configuration: neither topology
    nor features fit HBM (topo_residency=host, feature_residency=host),
    Kg=4 clique caches for both, staged transfer. The sample runs as a
    per-hop program chain with C++ host neighbor draws between programs
    (the reference's UVA miss branch, operator_impl.cu:224-243) and must
    be loss-identical to the callback path."""
    ds = small_dataset
    t_cb = Trainer(ds, _cfg_host_topo(ds, "callback"))
    t_st = Trainer(ds, _cfg_host_topo(ds, "staged"))
    assert not t_cb._staged_host and t_st._staged_host
    assert t_st._use_clique and t_st._use_clique_topo
    assert t_st.graph_access.needs_host_draws
    s_cb = t_cb.init_state()
    s_st = t_st.init_state()
    for _ in range(3):
        s_cb, l_cb = t_cb.train_step(s_cb)
        s_st, l_st = t_st.train_step(s_st)
        np.testing.assert_allclose(float(l_cb), float(l_st), rtol=1e-5,
                                   atol=1e-6)
    assert int(t_st.last_topo_total) > 0
    s_cb, acc_cb = t_cb.run_eval(s_cb, Mode.VALID)
    s_st, acc_st = t_st.run_eval(s_st, Mode.VALID)
    assert abs(acc_cb - acc_st) < 1e-6, (acc_cb, acc_st)


def test_staged_singledev_host_topology_matches_callback(small_dataset):
    """Single-device staged with host topology: the hot sub-CSR serves
    hits in-program, host draws cross between the per-hop programs."""
    ds = small_dataset
    t_cb = Trainer(ds, _cfg_host_topo(ds, "callback", n_dev=1))
    t_st = Trainer(ds, _cfg_host_topo(ds, "staged", n_dev=1))
    assert t_st._staged_host and t_st.graph_access.needs_host_draws
    s_cb = t_cb.init_state()
    s_st = t_st.init_state()
    for _ in range(2):
        s_cb, l_cb = t_cb.train_step(s_cb)
        s_st, l_st = t_st.train_step(s_st)
        np.testing.assert_allclose(float(l_cb), float(l_st), rtol=1e-5,
                                   atol=1e-6)


def test_staged_prefetch_pipeline_chains(trainers):
    """The one-step sample lookahead must produce the same losses when an
    eval pass interrupts the train chain (prefetch survives or resyncs)."""
    _, t_st = trainers
    s = t_st.init_state()
    s, l0 = t_st.train_step(s)
    s, _ = t_st.run_eval(s, Mode.VALID)
    s, l1 = t_st.train_step(s)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    # fresh trainer, no eval interruption: identical loss sequence
    t2 = Trainer(t_st.dataset, _cfg(t_st.dataset, "staged"))
    s2 = t2.init_state()
    s2, m0 = t2.train_step(s2)
    s2, m1 = t2.train_step(s2)
    np.testing.assert_allclose(float(l0), float(m0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(l1), float(m1), rtol=1e-5, atol=1e-6)
