"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.json): GraphSAGE [25,10] training throughput on a
products-scale power-law graph (2.4M vertices / 120M edges / feat 100,
batch 8000 — the reference's Fig. 8 ogbn-products configuration,
detail_parameter_settings/README.md:17-29), reported as end-to-end trained
edges/s: sampled aggregation edges consumed per wall-clock second by the
fused sample+gather+train step at steady state on one chip.

vs_baseline: the reference publishes no absolute numbers (BASELINE.md), so
the denominator is a fixed per-chip budget derived from the paper's setup:
8xA100 Legion sweeps ~25 steps x ~22M sampled edges per [25,10] epoch over
ogbn-products in about one second — ~70M trained edges/s per GPU. We pin
BASELINE_EDGES_PER_S = 70e6; vs_baseline = measured / 70e6, i.e. 1.0 ==
parity with one A100's share of the reference run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_EDGES_PER_S = 70e6


def make_dataset(features="hbm", nodes=2_400_000, edges=120_000_000,
                 feature_dim=100, batch=8000, seed=0):
    """The products-shaped synthetic graph. features="host" keeps the
    authoritative store in host RAM (generated host-side); "hbm" generates
    graph and features on the device."""
    if features == "host":
        from legion_tpu.data import synthesize_dataset
        return synthesize_dataset(
            num_nodes=nodes, avg_degree=max(edges // nodes, 1),
            feature_dim=feature_dim, num_classes=32, batch_size=batch,
            train_frac=0.08, seed=seed)
    import jax
    from legion_tpu.data.device_synthetic import synthesize_device_dataset
    ds = synthesize_device_dataset(
        num_nodes=nodes, num_edges=edges, feature_dim=feature_dim,
        batch_size=batch, seed=seed)
    jax.block_until_ready(ds.features)
    return ds


def make_config(meta, model="graphsage", batch=8000, fanouts=(25, 10),
                hidden=256, dedup="sort", exact_dedup=False, window=64,
                headroom=1.03, presample=8, features="hbm",
                cache_mem=200_000_000, fused_steps=1,
                host_transfer="callback", devices=1):
    """The Fig. 8 products training configuration (bench defaults)."""
    from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                                   SamplerConfig, TrainConfig)
    # lp_sage batches are (anchor, pos, neg) thirds
    eval_bs = 510 if model == "lp_sage" else 512
    if model == "lp_sage":
        assert batch % 3 == 0, "lp_sage needs a batch divisible by 3"
    return LegionConfig(
        dataset=meta,
        sampler=SamplerConfig(fanouts=tuple(fanouts),
                              batch_size=batch, auto_compact=True,
                              eval_batch_size=eval_bs,
                              dedup=dedup,
                              cap_headroom=headroom,
                              neighbor_window=window,
                              # gcn's block out-degree normalization needs
                              # exact node dedup; graphsage/gat/lp_sage
                              # take the lane-aligned last hop (gat via
                              # the projection-commute attention layer,
                              # models/gat.py)
                              dedup_last_hop=(exact_dedup
                                              or model == "gcn")),
        cache=CacheConfig(
            presample_steps=presample,
            cache_bytes=cache_mem if features == "host" else 0,
            feature_residency=features,
            host_transfer=host_transfer),
        train=TrainConfig(model=model, hidden_dim=hidden,
                          epochs=1,
                          fused_steps=(fused_steps
                                       if features == "hbm" else 1)),
        mesh=MeshConfig.for_devices(devices),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2_400_000)
    ap.add_argument("--edges", type=int, default=120_000_000)
    ap.add_argument("--feature-dim", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8000)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--model", default="graphsage")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--dedup", default="sort", choices=["map", "sort"])
    # exact reference dedup semantics on the last hop (the default
    # lane-aligned mode is training-math-identical for
    # graphsage/gat/lp_sage — see SamplerConfig.dedup_last_hop)
    ap.add_argument("--exact-dedup", action="store_true")
    # block-windowed neighbor draws (0 = exact per-slot independent draws)
    ap.add_argument("--window", type=int, default=64)
    # measured-cap headroom over the presampled per-hop max unique nodes.
    # The reference uses 1.2x (server.cu:277); with 8 presample probes the
    # max estimate is tight enough for 1.03x, which shrinks every
    # downstream buffer. Overflowing batches drop the excess nodes
    # (masked) — visible as node_slots dipping.
    ap.add_argument("--headroom", type=float, default=1.03)
    ap.add_argument("--presample", type=int, default=8)
    # feature residency: hbm = all features on chip (in-memory mode);
    # host = authoritative features in host RAM + hotness-driven HBM cache
    # (Legion's core scenario for graphs whose features exceed device
    # memory; misses become one batched host gather per step)
    ap.add_argument("--features", choices=["hbm", "host"], default="hbm")
    ap.add_argument("--cache-mem", type=int, default=200_000_000,
                    help="HBM feature-cache bytes for --features host")
    # steps per device dispatch (hbm mode). RNG and parameter sequence
    # identical to 1-step dispatches.
    ap.add_argument("--fused-steps", type=int, default=1)
    args = ap.parse_args()

    import jax
    from legion_tpu.train import Trainer

    t_setup = time.time()
    ds = make_dataset(args.features, args.nodes, args.edges,
                      args.feature_dim, args.batch)
    gen_s = time.time() - t_setup

    cfg = make_config(ds.meta, model=args.model, batch=args.batch,
                      fanouts=args.fanouts, hidden=args.hidden,
                      dedup=args.dedup, exact_dedup=args.exact_dedup,
                      window=args.window, headroom=args.headroom,
                      presample=args.presample, features=args.features,
                      cache_mem=args.cache_mem,
                      fused_steps=args.fused_steps)
    fused = cfg.train.fused_steps
    trainer = Trainer(ds, cfg)
    state = trainer.init_state()

    n_warm = max(args.warmup // fused, 1)
    t_compile = time.time()
    for _ in range(n_warm):
        state, loss = trainer.train_step(state)
    float(loss)
    compile_s = time.time() - t_compile

    n_calls = max(args.steps // fused, 1)
    n_steps = n_calls * fused
    t0 = time.time()
    for _ in range(n_calls):
        state, loss = trainer.train_step(state)
    float(loss)
    dt = time.time() - t0
    step_time = dt / n_steps

    # true valid-edge/node counts measured on one sampled batch with the
    # TRAINER's capped sampler, so cap-dropped nodes are not counted as
    # trained. With the lane-aligned last hop, num_nodes[-1] counts valid
    # LANES (duplicates included); the deduped unique count is recomputed
    # host-side so "unique_nodes_per_step" means the same thing in every
    # mode (round-1 advisor finding).
    sampler = trainer.sampler_t
    seeds = jax.lax.dynamic_slice(
        trainer.train_bank[0], (0,), (args.batch,))
    b, _ = sampler.sample(trainer.graph_access, seeds,
                          sampler.init_state(), jax.random.PRNGKey(1))
    valid_edges = int(np.asarray(b.num_edges).sum())
    ids_np = np.asarray(b.node_ids)
    node_slots = int(np.asarray(b.num_nodes)[-1])
    uniq_nodes = int(len(np.unique(ids_np[ids_np >= 0])))

    edges_per_s = valid_edges / step_time
    result = {
        "metric": f"{args.model}_fanout{'x'.join(map(str, args.fanouts))}"
                  f"_b{args.batch}_trained_edges_per_s",
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / BASELINE_EDGES_PER_S, 4),
        "extra": {
            "step_time_s": round(step_time, 5),
            "sampled_nodes_per_s": round(uniq_nodes / step_time, 1),
            "valid_edges_per_step": valid_edges,
            "unique_nodes_per_step": uniq_nodes,
            "node_slots_per_step": node_slots,
            "steps_measured": n_steps,
            "datagen_s": round(gen_s, 2),
            "warmup_s": round(compile_s, 2),
            "device": str(jax.devices()[0]),
            "last_loss": round(float(loss), 4),
        },
    }
    if trainer.cache_plan is not None:
        hits = int(trainer.last_feat_hits)
        result["extra"]["feat_cache_hits_per_step"] = hits
        # same-step counters: hits and slots come off the SAME final train
        # step (round-2 advisor: mixing batches could push the ratio >1)
        result["extra"]["feat_cache_hit_rate"] = round(
            hits / max(int(trainer.last_slots), 1), 4)
        result["extra"]["cache_alpha"] = round(trainer.cache_plan.alpha, 3)
        result["extra"]["cache_feat_rows"] = trainer.cache_plan.feature_capacity
    print(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
