"""Multi-host mesh path: a ("host", "clique", "member") mesh (virtual hosts
over the CPU device pool) must train end-to-end with per-partition seeds
and clique cache collectives confined to the single-host axes."""

import jax
import numpy as np
import pytest

from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                               SamplerConfig, TrainConfig)
from legion_tpu.parallel.mesh import make_mesh
from legion_tpu.train import Trainer


def test_multihost_mesh_axes():
    mesh = make_mesh(MeshConfig(num_cliques=2, clique_size=2),
                     num_hosts=2)
    assert mesh.axis_names == ("host", "clique", "member")
    assert dict(mesh.shape) == {"host": 2, "clique": 2, "member": 2}


def test_multihost_training_learns(small_dataset):
    ds = small_dataset
    mesh = make_mesh(MeshConfig(num_cliques=2, clique_size=2), num_hosts=2)
    cfg = LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=16,
                              eval_batch_size=64),
        cache=CacheConfig(),
        train=TrainConfig(model="graphsage", hidden_dim=32, epochs=10,
                          dropout=0.2),
        mesh=MeshConfig(num_cliques=2, clique_size=2),
    )
    trainer = Trainer(ds, cfg, mesh=mesh)
    assert trainer.n_dev == 8
    state, stats = trainer.fit(verbose=False)
    assert stats[-1].train_loss < stats[0].train_loss * 0.7
    assert stats[-1].valid_acc > 0.4, stats
