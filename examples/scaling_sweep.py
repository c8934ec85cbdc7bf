"""Multi-device scaling sweep + per-step collective-bytes accounting.

Runs the full clique-cached training configuration (host features + host
topology, the billion-edge residency) at 1/2/4/8 devices and reports
edges/s, scaling efficiency vs 1 device, feature/topology hit rates, and
the EXACT per-step bytes each device moves through the cache
collectives (static shapes make the accounting closed-form —
CliqueFeatureCache.collective_bytes / CliqueTopoCache.collective_bytes).

This is the harness for BASELINE.md's ">=70% scaling efficiency" target.
It runs on the virtual 8-CPU mesh (it sets JAX_PLATFORMS=cpu and
xla_force_host_platform_device_count itself), so the absolute edges/s and
the efficiency numbers characterize the CPU backend, not NVLink — the
collective-bytes columns are hardware-independent and exact.
Multi-host caveat: a multi-HOST mesh adds a "host" axis whose all_to_alls
ride the network; per-hop request coalescing across that axis is not
modeled here.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/scaling_sweep.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                                   SamplerConfig, TrainConfig)
    from legion_tpu.data import synthesize_dataset
    from legion_tpu.train import Trainer

    # sized so an 8-virtual-device step (8 shard computations sharing
    # this host's cores) finishes inside XLA:CPU's 40s collective
    # rendezvous window
    ds = synthesize_dataset(num_nodes=60_000, avg_degree=10,
                            feature_dim=64, num_classes=16,
                            batch_size=512, train_frac=0.3, seed=0)
    steps = 8
    results = []
    base = None
    for n_dev in (1, 2, 4, 8):
        cfg = LegionConfig(
            dataset=ds.meta,
            sampler=SamplerConfig(fanouts=(8, 4), batch_size=512,
                                  eval_batch_size=256, dedup="sort",
                                  neighbor_window=16,
                                  dedup_last_hop=False),
            cache=CacheConfig(cache_bytes=1_500_000, presample_steps=2,
                              feature_residency="host",
                              topo_residency="host" if n_dev > 1
                              else "hbm",
                              host_transfer="callback"),
            train=TrainConfig(model="graphsage", hidden_dim=32, epochs=1),
            mesh=MeshConfig.for_devices(n_dev, clique_size=n_dev),
        )
        t = Trainer(ds, cfg)
        state = t.init_state()
        for _ in range(2):
            state, loss = t.train_step(state)
        float(loss)
        t0 = time.time()
        edges = 0
        for _ in range(steps):
            state, loss = t.train_step(state)
            edges += int(t.last_edges)
        float(loss)
        dt = (time.time() - t0) / steps
        eps = edges / steps / dt
        if base is None:
            base = eps
        row = {
            "n_dev": n_dev,
            "step_ms": round(dt * 1e3, 1),
            "edges_per_s_M": round(eps / 1e6, 3),
            "scaling_eff": round(eps / (base * n_dev), 3),
            "feat_hit_rate": round(
                int(t.last_feat_hits) / max(int(t.last_slots), 1), 3),
        }
        # exact per-device per-step bytes through the cache collectives
        if t._use_clique:
            fb = t.feature_source.collective_bytes(
                t.sampler_t.max_ids,
                2 if t._feat_dtype == "bfloat16" else 4)
            row["feat_a2a_bytes_per_step"] = (fb["request_bytes"]
                                              + fb["response_bytes"])
            row["feat_a2a_offchip_bytes"] = fb["offchip_bytes"]
        if t._use_clique_topo:
            tb_total = {"request_bytes": 0, "response_bytes": 0,
                        "offchip_bytes": 0}
            for k, f in enumerate(cfg.sampler.fanouts):
                tb = t.graph_access.collective_bytes(
                    t.sampler_t.frontier_sizes[k], f)
                for key in tb_total:
                    tb_total[key] += tb[key]
            row["topo_a2a_bytes_per_step"] = (tb_total["request_bytes"]
                                              + tb_total["response_bytes"])
            row["topo_a2a_offchip_bytes"] = tb_total["offchip_bytes"]
            row["topo_hit_rate"] = round(
                int(t.last_topo_hits) / max(int(t.last_topo_total), 1), 3)
        results.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": results, "backend": "cpu-virtual",
                      "note": "edges/s + efficiency characterize the CPU "
                              "backend; collective-bytes columns are "
                              "exact for any backend"}))


if __name__ == "__main__":
    main()
