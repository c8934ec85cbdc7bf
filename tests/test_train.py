"""End-to-end training tests on the virtual 8-device CPU mesh: schedule
parity, loss decreases, accuracy beats chance, DP equivalence."""

import jax
import numpy as np
import pytest

from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                               SamplerConfig, TrainConfig)
from legion_tpu.pipeline import Mode, Schedule
from legion_tpu.train import Trainer


def test_schedule_matches_reference_formulas():
    # ipc_service.cu:60-132
    sch = Schedule.build(train_sizes=[10000, 12000], valid_sizes=[900, 1100],
                         test_sizes=[700, 500], batch_size=1000, epochs=2)
    assert sch.train_step == (10000 - 1) // 1000  # min partition, drop last
    assert sch.valid_step == (1100 - 1) // 512 + 1
    assert sch.valid_batch_sizes == tuple(
        (s - 1) // sch.valid_step + 1 for s in (900, 1100))
    assert sch.test_step == (700 - 1) // 512 + 1
    assert sch.max_step == (sch.train_step + sch.valid_step) * 2 \
        + sch.test_step
    # mode interleaving: train then valid within each epoch, test at end
    modes = [sch.mode_of(i) for i in range(sch.max_step)]
    per = sch.train_step + sch.valid_step
    assert modes[:sch.train_step] == [Mode.TRAIN] * sch.train_step
    assert modes[sch.train_step:per] == [Mode.VALID] * sch.valid_step
    assert modes[-sch.test_step:] == [Mode.TEST] * sch.test_step
    assert sch.local_id_of(sch.train_step) == 0  # first valid step


def _config(ds, n_dev=1, epochs=2, model="graphsage", batch=None):
    if batch is None:
        batch = max(16, 64 // n_dev)
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=batch,
                              eval_batch_size=64),
        cache=CacheConfig(),
        train=TrainConfig(model=model, hidden_dim=32, epochs=epochs,
                          dropout=0.2),
        mesh=MeshConfig.for_devices(n_dev),
    )


@pytest.mark.parametrize("n_dev", [1, 4])
def test_training_learns(small_dataset, n_dev):
    ds = small_dataset
    cfg = _config(ds, n_dev=n_dev, epochs=8)
    trainer = Trainer(ds, cfg)
    state, stats = trainer.fit(verbose=False)
    assert stats[-1].train_loss < stats[0].train_loss * 0.5
    # synthetic communities + prototype features: must beat 1/5 chance well
    assert stats[-1].valid_acc > 0.7, stats
    assert trainer.test_acc > 0.7


def test_dp_grad_equivalence(small_dataset):
    """Same global seed set split over 1 vs 2 devices must produce similar
    training (not identical — different RNG streams — but both learn)."""
    ds = small_dataset
    t1 = Trainer(ds, _config(ds, n_dev=1, epochs=4))
    t2 = Trainer(ds, _config(ds, n_dev=2, epochs=4))
    _, s1 = t1.fit(verbose=False)
    _, s2 = t2.fit(verbose=False)
    assert s1[-1].valid_acc > 0.4
    assert s2[-1].valid_acc > 0.4


def test_interbatch_pipeline_exact_equivalence(small_dataset):
    """The inter-batch pipelined step (TrainConfig.interbatch) must produce
    the EXACT loss sequence of the sequential step — same params and RNG
    stream, only the schedule differs (system_config.cuh:47 parity)."""
    import dataclasses
    ds = small_dataset
    cfg = _config(ds, n_dev=2, epochs=1)
    cfg_p = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, interbatch=True))
    t0, t1 = Trainer(ds, cfg), Trainer(ds, cfg_p)
    s0, s1 = t0.init_state(), t1.init_state()
    assert "carry_batch" in s1 and "carry_batch" not in s0
    for _ in range(4):
        s0, l0 = t0.train_step(s0)
        s1, l1 = t1.train_step(s1)
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6,
                                   atol=1e-7)
    # eval between train steps leaves the pipelined chain consistent
    s1, acc1 = t1.run_eval(s1, Mode.VALID)
    s0, acc0 = t0.run_eval(s0, Mode.VALID)
    assert abs(acc0 - acc1) < 1e-6
    s0, l0 = t0.train_step(s0)
    s1, l1 = t1.train_step(s1)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6, atol=1e-7)


def test_gcn_and_gat_train(small_dataset):
    ds = small_dataset
    for model in ("gcn", "gat"):
        cfg = _config(ds, n_dev=2, epochs=6, model=model)
        trainer = Trainer(ds, cfg)
        state, stats = trainer.fit(verbose=False)
        assert np.isfinite(stats[-1].train_loss), model
        assert stats[-1].valid_acc > 0.4, (model, stats)


def test_fused_steps_exact_equivalence(small_dataset):
    """K steps fused into one program (TrainConfig.fused_steps) must
    reproduce the 1-step path's parameter/RNG sequence exactly: after K
    single steps and one fused-K call, losses and counters agree."""
    import dataclasses
    ds = small_dataset
    cfg = _config(ds, n_dev=2, epochs=1)
    cfg_f = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, fused_steps=3))
    t0, t1 = Trainer(ds, cfg), Trainer(ds, cfg_f)
    s0, s1 = t0.init_state(), t1.init_state()
    losses = []
    for _ in range(3):
        s0, l0 = t0.train_step(s0)
        losses.append(float(l0))
    s1, l1 = t1.train_step(s1)
    np.testing.assert_allclose(float(l1), np.mean(losses), rtol=1e-5,
                               atol=1e-6)
    assert int(s0["train_ctr"]) == int(s1["train_ctr"]) == 3
    assert int(t1.last_edges) > 0
    # params identical after the same 3 updates
    p0 = jax.tree_util.tree_leaves(s0["params"])
    p1 = jax.tree_util.tree_leaves(s1["params"])
    for a, b in zip(p0, p1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)


def test_pad_feature_dim_exact_equivalence(small_dataset):
    """128-column feature padding (TrainConfig.pad_feature_dim) must be
    math-identical: pad columns are zero and layer-0 pad weight rows are
    zero, so the loss sequence matches the unpadded model exactly."""
    import dataclasses
    ds = small_dataset
    assert ds.meta.feature_dim % 128 != 0   # padding actually engages
    cfg = _config(ds, n_dev=1, epochs=1)
    cfg_np = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, pad_feature_dim=False))
    t1, t0 = Trainer(ds, cfg), Trainer(ds, cfg_np)
    assert t1.feat_pad == 128 and t0.feat_pad == ds.meta.feature_dim
    s1, s0 = t1.init_state(), t0.init_state()
    for _ in range(3):
        s0, l0 = t0.train_step(s0)
        s1, l1 = t1.train_step(s1)
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5,
                                   atol=1e-6)


def test_gat_aligned_streaming_multidev(small_dataset):
    """GAT's lane-aligned projection-commuted attention under shard_map
    on a 4-device mesh (round-5 layer, models/gat.py): the commuted
    einsums and dropout masks must compile and learn inside the manual
    sharding region (the chunked-scan predecessor hit varying-axes carry
    mismatches exactly here)."""
    ds = small_dataset
    from dataclasses import replace
    cfg = _config(ds, n_dev=4, epochs=6, model="gat")
    cfg = replace(cfg, sampler=replace(cfg.sampler, dedup_last_hop=False))
    trainer = Trainer(ds, cfg)
    state, stats = trainer.fit(verbose=False)
    assert np.isfinite(stats[-1].train_loss)
    assert stats[-1].valid_acc > 0.4, stats
