"""Training launcher CLI — the reference's legion_server.py + trainer
scripts as one entry point.

The reference launcher writes meta_config, sniffs NVLink cliques out of
nvidia-smi, and execs the C++ sampling server, while four nearly identical
torch scripts run the trainers (legion_server.py:39-111,
legion_graphsage.py:185-207). Here one process does all of it: dataset load,
mesh construction (the NVLink domain is the clique), PreSc, and the fused
train loop.

  python -m legion_tpu.run --dataset-path DIR --dataset-name products \
      --model graphsage --train-batch-size 8000 --epoch 2 \
      --cache-memory 38000000
"""

from __future__ import annotations

import argparse

import jax


def build_config(args):
    from legion_tpu.config import (CacheConfig, DatasetMeta, LegionConfig,
                                   MeshConfig, SamplerConfig, TrainConfig)
    if args.dataset_name in ("synthetic",):
        meta = None
    else:
        if args.dataset_name == "custom":
            # any Legion-format directory (e.g. tools/prepare output):
            # shapes probed from the files themselves
            from legion_tpu.data.format import infer_meta
            meta = infer_meta(args.dataset_path,
                              batch_size=args.train_batch_size,
                              cache_bytes=args.cache_memory,
                              epochs=args.epoch)
        else:
            meta = DatasetMeta.known(
                args.dataset_name, path=args.dataset_path,
                batch_size=args.train_batch_size,
                cache_bytes=args.cache_memory, epochs=args.epoch)
        if args.write_meta_config:
            meta.to_meta_config()  # reference-compatible artifact

    n_dev = args.devices or len(jax.devices())
    clique = args.clique_size or n_dev
    cache_enabled = args.cache_memory > 0 and args.features == "host"
    cfg = LegionConfig(
        dataset=meta,
        sampler=SamplerConfig(fanouts=tuple(args.fanout),
                              batch_size=args.train_batch_size,
                              auto_compact=not args.no_compact,
                              dedup=args.dedup,
                              neighbor_window=args.window,
                              # gcn needs exact dedup (block-degree
                              # normalization); gat runs lane-aligned via
                              # the streaming attention layer (bench.py)
                              dedup_last_hop=(args.exact_dedup
                                              or args.model == "gcn")),
        cache=CacheConfig(
            cache_bytes=args.cache_memory,
            feature_residency="host" if cache_enabled else "hbm",
            presample_steps=args.presample_steps),
        train=TrainConfig(model=args.model, hidden_dim=args.hidden,
                          dropout=args.dropout, lr=args.lr,
                          epochs=args.epoch),
        mesh=MeshConfig.for_devices(n_dev, clique_size=clique),
    )
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser("Legion server+trainer")
    # reference flags (legion_server.py:114-125)
    ap.add_argument("--dataset_path", "--dataset-path",
                    dest="dataset_path", type=str, default="./dataset")
    ap.add_argument("--dataset_name", "--dataset-name",
                    dest="dataset_name", type=str, default="synthetic")
    ap.add_argument("--train_batch_size", "--train-batch-size",
                    dest="train_batch_size", type=int, default=8000)
    ap.add_argument("--fanout", type=int, nargs="+", default=[25, 10])
    ap.add_argument("--epoch", type=int, default=2)
    ap.add_argument("--cache_memory", "--cache-memory",
                    dest="cache_memory", type=int, default=0)
    # trainer flags (legion_graphsage.py:191-203)
    ap.add_argument("--model", default="graphsage",
                    choices=["graphsage", "gcn", "gat", "lp_sage"])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=3e-3)
    # mesh and residency knobs
    ap.add_argument("--devices", type=int, default=0,
                    help="0 = all visible devices")
    ap.add_argument("--clique-size", type=int, default=0,
                    help="cache group size Kg; 0 = all devices")
    # multi-process / multi-host bring-up (jax.distributed); launch one
    # process per host with the same coordinator (reference scope: seeds
    # partitioned per clique via the `partition` file,
    # storage_management.cu:171-232 — here partitions map to global
    # devices across hosts)
    ap.add_argument("--coordinator", default="",
                    help="ip:port of process 0 for jax.distributed")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--features", choices=["hbm", "host"], default="hbm")
    ap.add_argument("--dedup", choices=["map", "sort"], default="sort")
    ap.add_argument("--exact-dedup", action="store_true",
                    help="dedup the last hop too (exact reference "
                         "semantics; slower — see "
                         "SamplerConfig.dedup_last_hop)")
    ap.add_argument("--window", type=int, default=64,
                    help="block-windowed neighbor draws; 0 = exact "
                         "per-slot independent draws")
    ap.add_argument("--no-compact", action="store_true")
    ap.add_argument("--presample-steps", type=int, default=0)
    ap.add_argument("--write-meta-config", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N epochs (0 = only at "
                         "the end)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from "
                         "--checkpoint-dir before training")
    # synthetic fallback sizing
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--avg-degree", type=int, default=15)
    ap.add_argument("--feature-dim", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    args = ap.parse_args(argv)

    mesh = None
    if args.coordinator:
        from legion_tpu.parallel import multihost
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)
        mesh = multihost.make_multihost_mesh(
            clique_size=args.clique_size or None)
        print(f"process {jax.process_index()}/{jax.process_count()}: "
              f"{jax.local_device_count()} local / "
              f"{jax.device_count()} global devices")

    cfg = build_config(args)
    if args.dataset_name == "synthetic":
        from legion_tpu.data import synthesize_dataset
        import dataclasses
        ds = synthesize_dataset(
            num_nodes=args.nodes, avg_degree=args.avg_degree,
            feature_dim=args.feature_dim, num_classes=args.classes,
            batch_size=args.train_batch_size, epochs=args.epoch)
        cfg = dataclasses.replace(cfg, dataset=ds.meta)
    else:
        from legion_tpu.data import LegionDataset
        ds = LegionDataset.load(cfg.dataset)

    from legion_tpu.train import Trainer
    trainer = Trainer(ds, cfg, mesh=mesh)
    print(f"mesh: {dict(trainer.mesh.shape)} | schedule: train "
          f"{trainer.schedule.train_step}/epoch, valid "
          f"{trainer.schedule.valid_step}, test {trainer.schedule.test_step}")
    if trainer.compact_caps:
        print(f"measured buffer caps: {trainer.compact_caps}")
    if trainer.cache_plan:
        p = trainer.cache_plan
        print(f"cache plan: alpha={p.alpha:.2f} feat_rows="
              f"{p.feature_capacity} topo_rows={p.topo_capacity}")
    state = None
    if args.resume:
        from legion_tpu.utils import restore_checkpoint
        state = restore_checkpoint(args.checkpoint_dir, trainer)
        print(f"resumed from {args.checkpoint_dir} at train_ctr "
              f"{int(state['train_ctr'])}")
    state, stats = trainer.fit(state, checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every)
    if args.checkpoint_dir:
        from legion_tpu.utils import save_checkpoint
        save_checkpoint(args.checkpoint_dir, state,
                        int(state["train_ctr"]))
        print(f"checkpoint saved to {args.checkpoint_dir}")
    return trainer, state, stats


if __name__ == "__main__":
    main()
