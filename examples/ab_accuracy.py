"""Accuracy A/B: windowed draws (window 0 vs 64) x last-hop dedup
(lane-aligned vs exact), same step budget — settles whether the fast
sampling paths cost model quality (round-2 review, Weak #3).

Trains GraphSAGE on a synthetic products-scale graph with LEARNABLE
structure (class-clustered features AND homophilous edges so multi-hop
aggregation carries signal) and reports val accuracy per arm after the
same number of steps, plus wall-clock per arm.

Usage: python examples/ab_accuracy.py [--nodes N --epochs E ...]
Prints one JSON line per arm.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def homophilous_dataset(num_nodes, avg_degree, feature_dim, num_classes,
                        batch_size, seed=0, p_intra=0.7):
    """Synthetic graph where ~p_intra of edges connect same-class vertices
    — neighbor aggregation then genuinely improves over feature-only
    classification, so sampling-quality differences show up in accuracy."""
    rng = np.random.default_rng(seed)
    V, E = num_nodes, num_nodes * avg_degree
    labels = rng.integers(0, num_classes, V).astype(np.int32)
    by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    src = rng.integers(0, V, E)
    intra = rng.random(E) < p_intra
    dst = np.empty(E, np.int64)
    for c in range(num_classes):
        m = intra & (labels[src] == c)
        dst[m] = rng.choice(by_class[c], m.sum())
    dst[~intra] = rng.integers(0, V, (~intra).sum())
    # weak node features: class signal mostly lives in the neighborhood
    protos = rng.standard_normal((num_classes, feature_dim)).astype(
        np.float32)
    feats = 0.4 * protos[labels] + rng.standard_normal(
        (V, feature_dim)).astype(np.float32)

    from legion_tpu.config import DatasetMeta
    from legion_tpu.data.format import LegionDataset
    from legion_tpu.graph import CSRGraph
    graph = CSRGraph.from_edges(np.concatenate([src, dst]),
                                np.concatenate([dst, src]), V)
    ids = rng.permutation(V).astype(np.int32)
    n_tr, n_va, n_te = int(V * 0.1), int(V * 0.05), int(V * 0.05)
    meta = DatasetMeta(path="mem://ab", batch_size=batch_size,
                       num_nodes=V, num_edges=graph.num_edges,
                       feature_dim=feature_dim, train_size=n_tr,
                       valid_size=n_va, test_size=n_te,
                       num_classes=num_classes, name="ab_homophilous")
    return LegionDataset(
        meta=meta, graph=graph, features=feats, labels=labels,
        train_ids=ids[:n_tr], valid_ids=ids[n_tr:n_tr + n_va],
        test_ids=ids[n_tr + n_va:n_tr + n_va + n_te])


def run_arm(ds, window, exact_dedup, epochs, batch, fanouts, hidden, seed):
    from legion_tpu.config import (CacheConfig, LegionConfig, MeshConfig,
                                   SamplerConfig, TrainConfig)
    from legion_tpu.train import Trainer
    cfg = LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=tuple(fanouts), batch_size=batch,
                              auto_compact=True, dedup="sort",
                              neighbor_window=window,
                              dedup_last_hop=exact_dedup),
        cache=CacheConfig(presample_steps=4),
        train=TrainConfig(model="graphsage", hidden_dim=hidden,
                          epochs=epochs, seed=seed),
        mesh=MeshConfig.for_devices(1),
    )
    trainer = Trainer(ds, cfg)
    t0 = time.time()
    state, stats = trainer.fit(verbose=False)
    dt = time.time() - t0
    return {
        "window": window,
        "dedup_last_hop": bool(exact_dedup),
        "val_acc_per_epoch": [round(s.valid_acc, 4) for s in stats],
        "final_val_acc": round(stats[-1].valid_acc, 4),
        "test_acc": round(trainer.test_acc, 4),
        "steps": trainer.schedule.train_step * epochs,
        "wallclock_s": round(dt, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--avg-degree", type=int, default=25)
    ap.add_argument("--feature-dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2000)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", default="w64,w0,w64exact",
                    help="comma list of w<window>[exact]")
    args = ap.parse_args()

    ds = homophilous_dataset(args.nodes, args.avg_degree, args.feature_dim,
                             args.classes, args.batch, seed=args.seed)
    for arm in args.arms.split(","):
        exact = arm.endswith("exact")
        w = int(arm.rstrip("exact").lstrip("w"))
        r = run_arm(ds, w, exact, args.epochs, args.batch, args.fanouts,
                    args.hidden, args.seed)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
