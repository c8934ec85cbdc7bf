"""Smoke test of the training path on NVIDIA GPUs, through the user entry
points, at the products scale of Legion's Fig. 8 settings.

    python chip_smoke.py             # one card: phases a-g
    python chip_smoke.py --cards 4   # four cards: the pooled clique cache

One card:
  a. card: nvidia-smi name and power limit, device kind, host RAM, native
     host runtime (must have built from source);
  b. main path: bench.py's defaults (2.4M vertices / 120M edges / feat 100,
     GraphSAGE [25,10], batch 8000, hidden 256, sort dedup, window 64, bf16)
     through Trainer: compile seconds, step ms, peak memory, 10 steps whose
     losses must be finite and falling;
  c. sampler invariants on products-scale batches (trainer's sampler and
     Legion's map dedup): every sampled edge is a CSR edge, deduped hops
     hold no duplicates, the position map is clean after the batch, and
     -1-padded / duplicate-seed batches behave;
  d. model parity at real widths for GraphSAGE, GCN (exact dedup), GAT
     (heads 8,1) and lp_sage against tests/reference_models.py, in float32
     ("highest" matmuls) and in the default bf16 compute; then 3 train steps
     of each at products scale with its memory;
  e. host-resident features with a 200 MB device cache: callback and staged
     transfer agree step for step, fetched rows are bit-exact, cache hits;
  f. the CLI: legion_tpu.run.main(["--epoch", "1"]) at its synthetic
     defaults (train, valid and test);
  g. plain XLA row gather and segment-sum at the shapes of the removed
     Pallas kernels, in ms per call.

Four cards (one process drives all four): a Kc=1 x Kg=4 mesh with features
and topology in host RAM behind the pooled CliqueFeatureCache (all_to_all)
and CliqueTopoCache; GraphSAGE at phase b's widths under each host_transfer;
the clique fetch of each card's batch ids must equal the host rows bit for
bit.

Any failed check raises, so the exit code is non-zero. The last line of
stdout is the only JSON result line, printed only when every phase passed on
a GPU. Without a GPU the script exits non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import bench  # noqa: E402
import reference_models  # noqa: E402

PRODUCTS = dict(
    nodes=2_400_000, edges=120_000_000, feature_dim=100, batch=8000,
    lp_batch=7998, eval_batch=512, lp_eval_batch=510, hidden=256,
    fanouts=(25, 10), window=64, steps=10, model_steps=3, host_steps=5,
    cards_steps=6, cache_bytes=200_000_000, cli_args=["--epoch", "1"],
    # shapes of the removed Pallas kernels' benchmark
    gather_rows=2_400_000, gather_width=128, gather_ids=1_247_232,
    seg_rows=200_704, seg_width=128, seg_out=8192)

INT32_MAX = np.iinfo(np.int32).max
_T0 = time.time()


def log(msg: str) -> None:
    print(f"{time.time() - _T0:7.1f}s {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _gib(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f} GiB"


def _train(trainer, steps: int, window: int = 5):
    """`steps` train steps, each timed to the end of its whole update, then
    a window of `window` back-to-back steps with one sync at its end.
    Returns (state, losses, first-step s, later per-step ms, window ms per
    step)."""
    import jax
    state = trainer.init_state()
    losses, ms = [], []
    for i in range(steps):
        t = time.time()
        state, loss = trainer.train_step(state)
        jax.block_until_ready((state, loss))
        ms.append((time.time() - t) * 1e3)
        losses.append(float(loss))
    check(np.all(np.isfinite(losses)), f"non-finite losses {losses}")
    t = time.time()
    for _ in range(window):
        state, loss = trainer.train_step(state)
    jax.block_until_ready((state, loss))
    window_ms = (time.time() - t) * 1e3 / max(window, 1)
    check(np.isfinite(float(loss)), "non-finite loss in the timed window")
    return state, losses, ms[0] / 1e3, ms[1:], window_ms


def _step_memory(trainer, state) -> dict:
    """The compiled train step's own memory plan (arguments, outputs and
    temporaries), read from XLA without running it."""
    args = (state["params"], state["opt_state"], state["pos_map"],
            state["train_ctr"], state["base_key"], trainer.train_bank,
            trainer.graph_access, trainer.feature_source,
            trainer.member_rows, trainer.topo_pairs, trainer.topo_blocks,
            trainer.train_ybank)
    ma = trainer._train_step.lower(*args).compile().memory_analysis()
    return dict(arg=ma.argument_size_in_bytes, out=ma.output_size_in_bytes,
                temp=ma.temp_size_in_bytes, alias=ma.alias_size_in_bytes)


# ---------------------------------------------------------------------------
# a. card
# ---------------------------------------------------------------------------
def phase_card(results: dict) -> None:
    import jax
    from legion_tpu import native
    d = jax.devices()[0]
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    log(f"[a] device_kind={d.device_kind} platform={d.platform} "
        f"count={len(jax.devices())} host_ram={ram / 2**30:.1f} GiB "
        f"cpus={os.cpu_count()} jax={jax.__version__}")
    ok = native.available()
    log(f"[a] native.available()={ok}"
        + ("" if ok else f" build error: {native.build_error()}"))
    check(ok, "native host runtime did not build")
    results["card"] = dict(kind=d.device_kind, host_ram_gib=ram / 2**30)


# ---------------------------------------------------------------------------
# b. main path
# ---------------------------------------------------------------------------
def phase_main(sz: dict, results: dict):
    from legion_tpu.train import Trainer
    t = time.time()
    ds = bench.make_dataset("hbm", sz["nodes"], sz["edges"],
                            sz["feature_dim"], sz["batch"])
    gen_s = time.time() - t
    cfg = bench.make_config(ds.meta, batch=sz["batch"],
                            fanouts=sz["fanouts"], hidden=sz["hidden"],
                            window=sz["window"])
    t = time.time()
    trainer = Trainer(ds, cfg)
    build_s = time.time() - t
    _, losses, first_s, ms, win = _train(trainer, sz["steps"], sz["steps"])
    peak = _peak_bytes()
    log(f"[b] graphsage products: datagen {gen_s:.1f}s, Trainer build "
        f"(presample + caps) {build_s:.1f}s, compile + first step "
        f"{first_s:.1f}s, synced step ms {[round(x, 1) for x in ms]}, "
        f"then {win:.2f} ms/step over {sz['steps']} unsynced steps, caps "
        f"{trainer.compact_caps}, peak {_gib(peak)}")
    log(f"[b] losses {[round(x, 4) for x in losses]}")
    check(np.mean(losses[-3:]) < losses[0],
          f"loss did not fall: {losses}")
    results["main"] = dict(datagen_s=gen_s, build_s=build_s,
                           compile_first_step_s=first_s,
                           step_ms=ms, window_ms_per_step=win,
                           peak_bytes=peak, losses=losses)
    return ds, trainer


# ---------------------------------------------------------------------------
# c. sampler invariants
# ---------------------------------------------------------------------------
def _edges_in_csr(dst_g, src_g, indptr, indices) -> np.ndarray:
    """Is src_g[i] a CSR neighbour of dst_g[i]? (vectorised membership)"""
    V = indptr.shape[0] - 1
    u, inv = np.unique(dst_g, return_inverse=True)
    starts = indptr[u]
    deg = indptr[u + 1] - starts
    row = np.repeat(np.arange(len(u), dtype=np.int64), deg)
    pos = np.repeat(starts - (np.cumsum(deg) - deg), deg) + np.arange(
        deg.sum(), dtype=np.int64)
    keys = row * V + indices[pos]
    return np.isin(inv.astype(np.int64) * V + src_g, keys)


def _check_batch(name, batch, seeds, pos_map, indptr, indices,
                 deduped_hops, uses_pos_map):
    ids = np.asarray(batch.node_ids)
    nn = np.asarray(batch.num_nodes)
    seeds = np.asarray(seeds)
    B = seeds.shape[0]
    n_valid_seeds = int((seeds >= 0).sum())
    check(nn[0] == n_valid_seeds, f"{name}: num_nodes[0]={nn[0]}")
    np.testing.assert_array_equal(ids[:B][seeds >= 0], seeds[seeds >= 0])
    n_edges = 0
    for k in range(batch.num_hops):
        s_l = np.asarray(batch.edge_src[k])
        d_l = np.asarray(batch.edge_dst[k])
        ok = s_l >= 0
        check(np.array_equal(d_l >= 0, ok), f"{name}: hop {k} pad mismatch")
        src_g, dst_g = ids[s_l[ok]], ids[d_l[ok]]
        check(np.all(dst_g >= 0) and np.all(src_g >= 0),
              f"{name}: hop {k} edge touches a -1 slot")
        inside = _edges_in_csr(dst_g.astype(np.int64),
                               src_g.astype(np.int64), indptr, indices)
        check(inside.all(), f"{name}: hop {k}: {int((~inside).sum())} of "
              f"{inside.size} sampled pairs are not CSR edges")
        check(int(np.asarray(batch.num_edges)[k]) == int(ok.sum()),
              f"{name}: hop {k} edge counter")
        n_edges += int(ok.sum())
    # seeds + every deduped hop's new nodes: one slot per distinct id
    # (duplicate seeds each keep their own slot, by the reference's rule)
    n_dedup = int(nn[deduped_hops])
    region = ids[n_valid_seeds:n_dedup]
    check(np.all(region >= 0), f"{name}: hole in the deduped region")
    check(np.unique(region).size == region.size,
          f"{name}: duplicate ids among deduped hops")
    check(not np.isin(region, seeds).any(),
          f"{name}: a seed was re-discovered")
    if uses_pos_map:
        check(np.all(np.asarray(pos_map) == INT32_MAX),
              f"{name}: position map not clean after the batch")
    return n_edges, n_dedup


def phase_sampler(ds, trainer, sz: dict, results: dict) -> None:
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    from legion_tpu.sampling import NeighborSampler
    indptr = np.asarray(ds.csr.indptr).astype(np.int64)
    indices = np.asarray(ds.csr.indices)
    B = sz["batch"]
    train = np.asarray(ds.train_ids)
    full = train[:B]
    padded = np.full(B, -1, np.int32)
    padded[:B // 3] = train[B:B + B // 3]
    dup = np.concatenate([train[:B // 2], train[:B - B // 2]])
    exact = NeighborSampler(
        replace(trainer.sampler_t.config, dedup="map", dedup_last_hop=True,
                neighbor_window=0, node_caps=None, auto_compact=False),
        ds.meta.num_nodes)
    L = len(sz["fanouts"])
    runs = [("trainer sampler (sort, window, aligned last hop)",
             trainer.sampler_t, trainer.graph_access, L - 1, False),
            ("map dedup, exact draws, every hop deduped", exact, ds.csr, L,
             True)]
    t = time.time()
    out = {}
    for name, sampler, access, deduped_hops, uses_pm in runs:
        for probe, seeds in (("full", full), ("-1 padded", padded),
                             ("duplicate seeds", dup)):
            batch, pm = sampler.sample(access, jnp.asarray(seeds),
                                       sampler.init_state(),
                                       jax.random.PRNGKey(11))
            n_e, n_d = _check_batch(f"{name} / {probe}", batch, seeds, pm,
                                    indptr, indices, deduped_hops, uses_pm)
            log(f"[c] ok: {name} / {probe}: {n_e} sampled edges in CSR, "
                f"{n_d} deduped slots")
            out[f"{name} / {probe}"] = n_e
    log(f"[c] sampler invariants {time.time() - t:.1f}s")
    results["sampler"] = out


# ---------------------------------------------------------------------------
# d. model parity + per-model train steps
# ---------------------------------------------------------------------------
def phase_parity(ds, sz: dict, results: dict) -> None:
    import jax
    import jax.numpy as jnp
    from legion_tpu.config import SamplerConfig, TrainConfig
    from legion_tpu.models import make_model
    from legion_tpu.sampling import NeighborSampler
    from legion_tpu.sampling.access import WindowedCSRAccess
    V, F = ds.meta.num_nodes, ds.meta.feature_dim
    C = ds.meta.num_classes
    access = WindowedCSRAccess.from_csr(ds.csr, sz["window"])
    out = {}
    for model in ("graphsage", "gcn", "gat", "lp_sage"):
        t = time.time()
        bs = sz["lp_eval_batch"] if model == "lp_sage" else sz["eval_batch"]
        scfg = SamplerConfig(fanouts=sz["fanouts"], batch_size=bs,
                             eval_batch_size=bs, dedup="sort",
                             neighbor_window=sz["window"],
                             dedup_last_hop=model == "gcn")
        sampler = NeighborSampler(scfg, V)
        seeds = jnp.asarray(np.asarray(ds.valid_ids)[:bs])
        batch, _ = sampler.sample(access, seeds, sampler.init_state(),
                                  jax.random.PRNGKey(5))
        nid = np.asarray(batch.node_ids)[:sampler.max_ids]
        feats = np.array(ds.features[jnp.clip(jnp.asarray(nid), 0)])
        feats[nid < 0] = 0
        tcfg = TrainConfig(model=model, hidden_dim=sz["hidden"],
                           gat_heads=(8, 1), compute_dtype="float32")
        m32 = make_model(tcfg, scfg, F, C)
        params = m32.init(jax.random.PRNGKey(3))
        ref = reference_models.FORWARD[model](
            reference_models.to_numpy(params), feats, batch.edge_src, batch.edge_dst,
            scfg.cum_sizes(), bs)
        with jax.default_matmul_precision("highest"):
            got32 = np.asarray(jax.jit(m32.apply)(
                params, jnp.asarray(feats), batch), np.float64)
        mbf = make_model(
            TrainConfig(model=model, hidden_dim=sz["hidden"],
                        gat_heads=(8, 1), compute_dtype="bfloat16"),
            scfg, F, C)
        gotbf = np.asarray(jax.jit(mbf.apply)(
            params, jnp.asarray(feats, jnp.bfloat16), batch), np.float64)
        scale = float(np.abs(ref).max())
        err32 = float(np.abs(got32 - ref).max())
        rel32 = float((np.abs(got32 - ref)
                       / (1e-4 + 1e-4 * np.abs(ref))).max())
        errbf = float(np.abs(gotbf - ref).max())
        log(f"[d] {model}: batch {bs}, {sampler.max_ids} node slots, "
            f"out {ref.shape}, max|ref| {scale:.4g}; f32/highest max abs "
            f"err {err32:.3g} (tolerance use {rel32:.3f} of rtol=atol="
            f"1e-4); bf16/default max abs err {errbf:.3g} = "
            f"{errbf / scale:.3g} x max|ref| (bound 3e-2); "
            f"{time.time() - t:.1f}s")
        np.testing.assert_allclose(got32, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{model} f32 parity")
        check(errbf <= 3e-2 * scale, f"{model} bf16 parity: {errbf}")
        out[model] = dict(err_f32=err32, err_bf16=errbf, max_ref=scale)
    results["parity"] = out


def phase_models(ds, sz: dict, results: dict) -> None:
    from legion_tpu.train import Trainer
    out = {}
    for model in ("gcn", "gat", "lp_sage"):
        bs = sz["lp_batch"] if model == "lp_sage" else sz["batch"]
        cfg = bench.make_config(ds.meta, model=model, batch=bs,
                                fanouts=sz["fanouts"], hidden=sz["hidden"],
                                window=sz["window"])
        t = time.time()
        trainer = Trainer(ds, cfg)
        build_s = time.time() - t
        t = time.time()
        mem = _step_memory(trainer, trainer.init_state())
        compile_s = time.time() - t
        _, losses, first_s, ms, win = _train(trainer, sz["model_steps"])
        peak = _peak_bytes()
        prog = mem["arg"] + mem["out"] + mem["temp"] - mem["alias"]
        log(f"[d] {model} train at batch {bs}: build {build_s:.1f}s, "
            f"step compile {compile_s:.1f}s, first step {first_s:.1f}s, "
            f"later synced steps ms {[round(x, 1) for x in ms]}, then "
            f"{win:.2f} ms/step unsynced, step program memory "
            f"{_gib(prog)} (temp {_gib(mem['temp'])}), process peak "
            f"so far {_gib(peak)}, losses {[round(x, 4) for x in losses]}")
        out[model] = dict(batch=bs, compile_s=compile_s,
                          first_step_s=first_s,
                          step_ms=ms, window_ms_per_step=win, program_bytes=prog,
                          temp_bytes=mem["temp"], process_peak=peak,
                          losses=losses)
        del trainer
        gc.collect()
    results["models"] = out


# ---------------------------------------------------------------------------
# e. host-resident features
# ---------------------------------------------------------------------------
def _check_rows(rows, ids, host_feats, what):
    import ml_dtypes
    ids = np.asarray(ids)
    exp = np.zeros((ids.shape[0], host_feats.shape[1]), ml_dtypes.bfloat16)
    exp[ids >= 0] = host_feats[ids[ids >= 0]].astype(ml_dtypes.bfloat16)
    rows = np.asarray(rows)
    check(rows.dtype == exp.dtype, f"{what}: dtype {rows.dtype}")
    check(np.array_equal(rows.view(np.uint16), exp.view(np.uint16)),
          f"{what}: fetched rows differ from host_feats[ids]")


def phase_host(sz: dict, results: dict) -> None:
    import jax
    import jax.numpy as jnp
    from legion_tpu.train import Trainer
    t = time.time()
    hds = bench.make_dataset("host", sz["nodes"], sz["edges"],
                             sz["feature_dim"], sz["batch"])
    gen_s = time.time() - t
    log(f"[e] host dataset {hds.meta.num_nodes} x {hds.meta.num_edges} "
        f"edges generated in {gen_s:.1f}s")
    trainers, runs = {}, {}
    for transfer in ("callback", "staged"):
        cfg = bench.make_config(hds.meta, batch=sz["batch"],
                                fanouts=sz["fanouts"], hidden=sz["hidden"],
                                window=sz["window"], features="host",
                                cache_mem=sz["cache_bytes"],
                                host_transfer=transfer)
        t = time.time()
        trainers[transfer] = Trainer(hds, cfg)
        runs[transfer] = dict(build_s=time.time() - t, losses=[], ms=[])
        check(trainers[transfer]._staged_host == (transfer == "staged"),
              f"{transfer} path not taken")
    # lockstep: both paths take every step from the SAME state, so each
    # step's loss compares the two transfer paths on identical params and
    # batch. (Free-running trajectories are not comparable on the GPU:
    # atomic scatter-adds in the backward pass sum in a varying order, and
    # Adam's early sign-like updates amplify those last-bit differences.)
    state = trainers["callback"].init_state()
    for _ in range(sz["host_steps"]):
        twin = jax.tree.map(jnp.copy, state)
        jax.block_until_ready(twin)
        for transfer, st in (("staged", twin), ("callback", state)):
            t = time.time()
            new, loss = trainers[transfer].train_step(st)
            jax.block_until_ready((new, loss))
            runs[transfer]["ms"].append((time.time() - t) * 1e3)
            runs[transfer]["losses"].append(float(loss))
            if transfer == "callback":
                state = new
    for transfer, trainer in trainers.items():
        r = runs[transfer]
        check(np.all(np.isfinite(r["losses"])), f"{transfer} losses")
        r["hits"] = hits = int(trainer.last_feat_hits)
        r["slots"] = slots = int(trainer.last_slots)
        log(f"[e] {transfer}: cache rows "
            f"{trainer.cache_plan.feature_capacity}, build "
            f"{r['build_s']:.1f}s, step ms (first includes compile) "
            f"{[round(x, 1) for x in r['ms']]}, hits {hits} of {slots} "
            f"slots, losses {[round(x, 5) for x in r['losses']]}")
        check(hits > 0, f"{transfer}: no cache hits")
        if transfer == "callback":
            # one batch's rows through the cached fetch (hits from the
            # device cache, misses from host RAM via the callback)
            s = trainer.sampler_t
            seeds = jnp.asarray(np.asarray(hds.train_ids)[:sz["batch"]])
            batch, _ = s.sample(trainer.graph_access, seeds, s.init_state(),
                                jax.random.PRNGKey(2))
            nid = batch.node_ids[:s.max_ids]
            rows, nh = jax.jit(lambda fs, i: fs.fetch(i))(
                trainer.feature_source, nid)
            _check_rows(rows, nid, hds.features, "callback fetch")
            log(f"[e] fetch of one batch ({s.max_ids} slots, {int(nh)} "
                f"cache hits) equals host_feats[ids] as bf16, bit for bit")
        trainer.close()
    del trainers
    gc.collect()
    lc, ls = runs["callback"]["losses"], runs["staged"]["losses"]
    rel = float(np.max(np.abs(np.subtract(ls, lc)) / np.abs(lc)))
    np.testing.assert_allclose(ls, lc, rtol=1e-4,
                               err_msg="callback vs staged losses")
    check(np.mean(lc[-3:]) < lc[0], f"host-feature loss did not fall: {lc}")
    log(f"[e] callback and staged per-step losses agree: max rel diff "
        f"{rel:.3g} (bound 1e-4)")
    results["host"] = dict(datagen_s=gen_s, **runs)


# ---------------------------------------------------------------------------
# f. CLI
# ---------------------------------------------------------------------------
def phase_cli(sz: dict, results: dict) -> None:
    from legion_tpu import run
    t = time.time()
    trainer, _, stats = run.main(list(sz["cli_args"]))
    dt = time.time() - t
    check(len(stats) >= 1 and np.isfinite(stats[-1].train_loss),
          f"CLI stats {stats}")
    check(trainer.test_acc is not None and 0.0 <= trainer.test_acc <= 1.0,
          f"CLI test acc {trainer.test_acc}")
    log(f"[f] CLI {' '.join(sz['cli_args'])}: {dt:.1f}s, loss "
        f"{stats[-1].train_loss:.4f}, val acc {stats[-1].valid_acc:.4f}, "
        f"test acc {trainer.test_acc:.4f}")
    results["cli"] = dict(seconds=dt, train_loss=stats[-1].train_loss,
                          valid_acc=stats[-1].valid_acc,
                          test_acc=trainer.test_acc)
    trainer.close()


# ---------------------------------------------------------------------------
# g. XLA baselines for the removed Pallas kernels
# ---------------------------------------------------------------------------
def _time_ms(fn, *args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))
    t = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t) / reps * 1e3


def phase_xla_baselines(sz: dict, results: dict) -> None:
    import jax
    import jax.numpy as jnp
    from legion_tpu.ops import gather_rows, masked_segment_sum
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    R, W, N = sz["gather_rows"], sz["gather_width"], sz["gather_ids"]
    table = jax.random.normal(k1, (R, W), jnp.bfloat16)
    ids = jax.random.randint(k2, (N,), 0, R, jnp.int32)
    g = jax.jit(gather_rows)
    got = g(table, ids)
    check(np.array_equal(np.asarray(got[:64]),
                         np.asarray(table)[np.asarray(ids[:64])]),
          "gather baseline wrong")
    g_ms = _time_ms(g, table, ids)
    g_bytes = 2 * N * W * 2             # read + write of the gathered rows
    S, SW, O = sz["seg_rows"], sz["seg_width"], sz["seg_out"]
    data = jax.random.normal(k3, (S, SW), jnp.float32)
    seg = jax.random.randint(k4, (S,), 0, O, jnp.int32)
    s = jax.jit(masked_segment_sum, static_argnums=(2,))
    got = np.asarray(s(data, seg, O))
    ref = np.zeros((O, SW), np.float64)
    np.add.at(ref, np.asarray(seg), np.asarray(data, np.float64))
    check(np.allclose(got, ref, rtol=1e-4, atol=1e-3),
          "segment-sum baseline wrong")
    s_ms = _time_ms(s, data, seg, O)
    s_bytes = S * SW * 4 + S * 4 + O * SW * 4
    log(f"[g] XLA row gather {R}x{W} bf16 by {N} ids: {g_ms:.3f} ms/call "
        f"({g_bytes / g_ms / 1e6:.0f} GB/s of rows read+written)")
    log(f"[g] XLA .at[].add segment-sum {S}x{SW} f32 into {O} rows: "
        f"{s_ms:.3f} ms/call ({s_bytes / s_ms / 1e6:.0f} GB/s)")
    results["xla_baselines"] = dict(gather_ms=g_ms, segment_sum_ms=s_ms)


# ---------------------------------------------------------------------------
# four cards: pooled clique cache
# ---------------------------------------------------------------------------
def _clique_fetch(trainer, ids):
    """CliqueFeatureCache.fetch of ids [n_dev, N] inside the trainer's
    mesh: hits served by the owners over all_to_all, misses from host."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def f(ids, fsource, member_rows):
        rows, hits = fsource.fetch(ids[0], member_rows[0])
        return rows[None], jax.lax.psum(hits, trainer.axes)

    sm = trainer._shard_map(
        f, trainer.mesh,
        in_specs=(trainer._DPN, P(), P("member", None, None)),
        out_specs=(P(trainer.axes, None, None), P()))
    ids = jax.device_put(ids, NamedSharding(trainer.mesh, trainer._DPN))
    return jax.jit(sm)(ids, trainer.feature_source, trainer.member_rows)


def run_cards(sz: dict, n_cards: int, results: dict) -> None:
    import jax
    import jax.numpy as jnp
    from legion_tpu.config import MeshConfig
    from legion_tpu.sampling import NeighborSampler
    from legion_tpu.train import Trainer
    from dataclasses import replace
    check(len(jax.devices()) >= n_cards,
          f"need {n_cards} devices, have {len(jax.devices())}")
    t = time.time()
    hds = bench.make_dataset("host", sz["nodes"], sz["edges"],
                             sz["feature_dim"], sz["batch"])
    log(f"[4] host dataset {hds.meta.num_nodes} x {hds.meta.num_edges} "
        f"edges generated in {time.time() - t:.1f}s")
    runs = {}
    for transfer in ("callback", "staged"):
        cfg = bench.make_config(hds.meta, batch=sz["batch"],
                                fanouts=sz["fanouts"], hidden=sz["hidden"],
                                window=sz["window"], features="host",
                                cache_mem=sz["cache_bytes"],
                                host_transfer=transfer, devices=n_cards)
        cfg = replace(cfg, cache=replace(cfg.cache, topo_residency="host"))
        check(cfg.mesh == MeshConfig(num_cliques=1, clique_size=n_cards),
              f"mesh {cfg.mesh}")
        t = time.time()
        trainer = Trainer(hds, cfg)
        build_s = time.time() - t
        check(trainer._use_clique and trainer._use_clique_topo,
              "clique feature and topology caches must both be active")
        check(trainer._staged_host == (transfer == "staged"),
              f"{transfer} path not taken")
        if transfer == "callback":
            s = NeighborSampler(trainer.sampler_t.config,
                                hds.meta.num_nodes)
            csr = hds.graph.to_device()
            bank = np.asarray(trainer.train_bank)
            ids = np.stack([np.asarray(s.sample(
                csr, jnp.asarray(bank[d, :sz["batch"]]), s.init_state(),
                jax.random.PRNGKey(d))[0].node_ids[:s.max_ids])
                for d in range(n_cards)])
            del csr
            rows, hits = _clique_fetch(trainer, ids)
            rows = np.asarray(rows)
            for d in range(n_cards):
                _check_rows(rows[d], ids[d], hds.features,
                            f"clique fetch on card {d}")
            log(f"[4] clique fetch of {n_cards} batches x {ids.shape[1]} "
                f"slots equals host_feats[ids] bit for bit; collective "
                f"hits {int(hits)} of {int((ids >= 0).sum())} ids")
            check(int(hits) > 0, "clique fetch served no hits")
        _, losses, first_s, ms, win = _train(trainer, sz["cards_steps"])
        fh = int(trainer.last_feat_hits)
        th, tt = int(trainer.last_topo_hits), int(trainer.last_topo_total)
        log(f"[4] {transfer}: mesh {dict(trainer.mesh.shape)}, pooled "
            f"feature rows {trainer.cache_plan.feature_capacity}, topo rows "
            f"{trainer.cache_plan.topo_capacity}, build {build_s:.1f}s, "
            f"compile + first step {first_s:.1f}s, later synced steps ms "
            f"{[round(x, 1) for x in ms]}, then {win:.2f} ms/step "
            f"unsynced, feat_hits={fh} "
            f"topo_hits={th}/{tt}, losses "
            f"{[round(x, 4) for x in losses]}")
        check(np.mean(losses[-3:]) < losses[0],
              f"{transfer}: loss did not fall: {losses}")
        check(fh > 0 and th > 0, f"{transfer}: cache hits {fh}, {th}")
        runs[transfer] = dict(build_s=build_s, compile_first_step_s=first_s,
                              step_ms=ms, window_ms_per_step=win,
                              feat_hits=fh, topo_hits=th,
                              topo_total=tt, losses=losses)
        trainer.close()
        del trainer
        gc.collect()
    results["cards"] = runs


def run_one_card(sz: dict, results: dict) -> None:
    phase_card(results)
    ds, trainer = phase_main(sz, results)
    phase_sampler(ds, trainer, sz, results)
    del trainer
    gc.collect()
    phase_parity(ds, sz, results)
    phase_models(ds, sz, results)
    del ds
    gc.collect()
    phase_host(sz, results)
    phase_cli(sz, results)
    phase_xla_baselines(sz, results)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4 runs only the pooled-cache path on four cards")
    args = ap.parse_args(argv)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (found {devs[0].platform}); nothing "
                 "was run")
    import legion_tpu  # noqa: F401  (sets the compile cache first)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi[:max(args.cards, 1)]:
        print(line)
    t0 = time.time()
    results: dict = {"nvidia_smi": smi}
    if args.cards == 1:
        run_one_card(PRODUCTS, results)
    else:
        phase_card(results)
        run_cards(PRODUCTS, args.cards, results)
    results["seconds"] = time.time() - t0
    log("[done] " + json.dumps(results, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
