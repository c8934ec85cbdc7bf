"""End-to-end trainer: fused sample -> feature gather -> model -> update.

This collapses the reference's three cooperating layers — the sampling server
hot loop (server.cu:302-332), the CUDA-IPC handoff (ipc_service.cu), and the
DDP trainer processes (legion_graphsage.py:121-183) — into ONE jitted SPMD
program per step. The sampler and model share the device, so the
zero-copy process handoff is simply function composition, and DDP+NCCL
becomes a `lax.pmean` over the mesh.

Zero-host-traffic hot loop: all seed sets live on device as padded "banks"
(the device-side analog of BatchGenerate's seed slicing,
operator_impl.cu:92-172), the step/epoch counters and RNG keys are device
state, and losses/metrics accumulate on device. A training step consumes NO
host inputs — the host only chooses which compiled function to invoke, so
steps pipeline back-to-back with async dispatch (the reference needed a
3-stream event DAG + semaphore pipeline for the same overlap).

Data parallelism: `shard_map` over the ("clique", "member") mesh; each device
samples from its own partition's seeds with its own position map and RNG
stream, computes grads, and grads/metrics are mean/sum-reduced across the
mesh — exactly the reference's one-replica-per-GPU + allreduce structure
(legion_graphsage.py:139-140).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map

    def _shard_map(f, mesh, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _esm

    def _shard_map(f, mesh, in_specs, out_specs):
        return _esm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

from legion_tpu.config import LegionConfig
from legion_tpu.models import make_model
from legion_tpu.parallel.mesh import DP_AXES, dp_axes, dp_size, make_mesh
from legion_tpu.pipeline import Mode, Schedule
from legion_tpu.sampling import NeighborSampler

# Sharding specs are built per-Trainer from the mesh's axis names, so a
# multi-host mesh ("host", "clique", "member") works unchanged — every mesh
# axis is data-parallel; "member" additionally carries cache collectives.


def _masked_ce(logits: jax.Array, labels: jax.Array,
               valid: jax.Array) -> jax.Array:
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.maximum(labels, 0))
    w = valid.astype(logits.dtype)
    return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1)


@dataclass
class EpochStats:
    epoch: int
    train_loss: float
    valid_acc: float
    seconds: float


def _build_bank(sets: List[np.ndarray], steps: int, static_bs: int,
                batch_sizes: List[int]) -> np.ndarray:
    """[n_dev, steps*static_bs] seed bank; step s of device d occupies
    [s*static_bs, s*static_bs + batch_sizes[d]), -1 padded — this encodes
    the per-partition batch sizes of the reference coordinator
    (ipc_service.cu:88-115) while keeping every device's slice uniform."""
    n_dev = len(sets)
    bank = np.full((n_dev, steps * static_bs), -1, np.int32)
    for d, ids in enumerate(sets):
        bs = batch_sizes[d]
        for s in range(steps):
            chunk = ids[s * bs:(s + 1) * bs]
            bank[d, s * static_bs: s * static_bs + len(chunk)] = chunk
    return bank


class Trainer:
    def __init__(self, dataset, config: LegionConfig,
                 mesh: Optional[jax.sharding.Mesh] = None):
        self.config = config
        self.dataset = dataset
        self.mesh = mesh if mesh is not None else make_mesh(config.mesh)
        self.n_dev = dp_size(self.mesh)
        self.axes = dp_axes(self.mesh)
        self._DP = P(self.axes)
        self._DPN = P(self.axes, None)
        meta = dataset.meta
        V = meta.num_nodes
        scfg = config.sampler

        rep = NamedSharding(self.mesh, P())
        dpn = NamedSharding(self.mesh, self._DPN)

        # --- seed sets ---
        if hasattr(dataset, "device_arrays"):
            train_sets, valid_sets, test_sets = dataset.seed_sets(self.n_dev)
        else:
            train_sets = [dataset.seeds_for_partition("train", d, self.n_dev)
                          for d in range(self.n_dev)]
            valid_sets = [dataset.seeds_for_partition("valid", d, self.n_dev)
                          for d in range(self.n_dev)]
            test_sets = [dataset.seeds_for_partition("test", d, self.n_dev)
                         for d in range(self.n_dev)]

        self.schedule = Schedule.build(
            [len(s) for s in train_sets], [len(s) for s in valid_sets],
            [len(s) for s in test_sets], scfg.batch_size,
            config.train.epochs, scfg.eval_batch_size)
        sch = self.schedule

        # --- device-resident seed banks + label banks ---
        # labels ride the banks instead of a replicated [V] table: a seed's
        # label is fetched ONCE at bank-build time, so device label state
        # is O(seeds), not O(V) — at clueweb scale the [V] table alone
        # would be 4GB/replica (SURVEY §7 billion-vertex plan)
        if hasattr(dataset, "device_arrays"):
            labels_np = np.asarray(dataset.labels, np.int32)
        else:
            labels_np = np.asarray(dataset.labels[:V], np.int32)

        def _banks(sets, steps, static_bs, batch_sizes):
            bank = _build_bank([np.asarray(s) for s in sets], steps,
                               static_bs, batch_sizes)
            ybank = np.where(bank >= 0,
                             labels_np[np.clip(bank, 0, V - 1)], 0)
            return jax.device_put(bank, dpn), \
                jax.device_put(ybank.astype(np.int32), dpn)

        self.train_bank, self.train_ybank = _banks(
            train_sets, sch.train_step, scfg.batch_size,
            [sch.train_batch_size] * self.n_dev)
        self.valid_bank, self.valid_ybank = _banks(
            valid_sets, sch.valid_step, scfg.eval_batch_size,
            list(sch.valid_batch_sizes))
        self.test_bank, self.test_ybank = _banks(
            test_sets, sch.test_step, scfg.eval_batch_size,
            list(sch.test_batch_sizes))

        # --- samplers (the train sampler may be rebuilt with measured
        # buffer caps by _setup_storage's presampling) ---
        self.sampler_t = NeighborSampler(scfg, V)
        eval_scfg = replace(scfg, batch_size=scfg.eval_batch_size,
                            node_caps=None, auto_compact=False)
        self.sampler_e = NeighborSampler(eval_scfg, V)

        # --- storage residency + PreSc (presample -> caps -> cost model ->
        # cache FillUp), reference server.cu:90-117 ---
        self._setup_storage(rep)

        if self.compact_caps is not None:
            # eval buffers: an eval batch draws from fewer seeds than a
            # train batch over the same graph, so the measured train caps
            # bound eval's unique-node growth too — no more worst-case
            # 25x10 eval buffers (round-2 review, Weak #6)
            worst_e = self.sampler_e.config.cum_sizes()
            ecaps = (scfg.eval_batch_size,) + tuple(
                min(w, c) for w, c in zip(worst_e[1:],
                                          self.compact_caps[1:]))
            eval_scfg = replace(eval_scfg, node_caps=ecaps)
            self.sampler_e = NeighborSampler(eval_scfg, V)

        # --- models (shapes follow the final sampler configs) ---
        self.model_t = make_model(config.train, self.sampler_t.config,
                                  meta.feature_dim, meta.num_classes,
                                  in_dim_pad=self.feat_pad)
        self.model_e = make_model(config.train, eval_scfg, meta.feature_dim,
                                  meta.num_classes,
                                  in_dim_pad=self.feat_pad)
        self.tx = optax.adam(config.train.lr)

        self.is_lp = config.train.model == "lp_sage"
        if self.is_lp:
            assert scfg.batch_size % 3 == 0 and \
                scfg.eval_batch_size % 3 == 0, (
                    "lp_sage batches are (anchor, pos, neg) thirds "
                    "(lp_sage.py:86-97)")
        if config.train.fused_steps > 1:
            assert not self._staged_host and not config.train.interbatch, (
                "fused_steps applies to the fused single-program path")
        if self._staged_host:
            self._build_staged_steps()
        else:
            self._train_step = self._build_train_step()
            self._eval_steps = {
                Mode.VALID: self._build_eval_step(sch.valid_step,
                                                  "valid_ctr"),
                Mode.TEST: self._build_eval_step(sch.test_step, "test_ctr"),
            }
        self.test_acc: Optional[float] = None

    # ------------------------------------------------------------------
    def _setup_storage(self, rep) -> None:
        """Decide residency and run the PreSc pipeline when needed:
        presample hotness/buffer-sizing -> measured node caps -> cost
        model -> cache FillUp -> cached access paths
        (reference: server.cu:90-117, cache.cu:360-611)."""
        from legion_tpu.cache import plan_cache, presample_hotness
        from legion_tpu.cache.unified_cache import (
            CachedFeatureSource, DeviceFeatureSource, UnifiedCache)
        from legion_tpu.sampling.access import (CachedTopoAccess,
                                                DeviceCSRAccess)

        dataset, config = self.dataset, self.config
        meta = dataset.meta
        V = meta.num_nodes
        scfg = config.sampler
        cache_cfg = config.cache
        self.cache_plan = None
        self.compact_caps = None
        self._use_clique = False
        self._use_clique_topo = False
        self._staged_host = False
        self.member_rows = jnp.zeros((1, 1, 1), jnp.float32)
        # clique-topology shards: per-member (row_pairs, indices2d) of the
        # partitioned hot sub-CSR, bound into the access inside shard_map
        self.topo_pairs = jnp.zeros((1, 1, 2), jnp.int32)
        self.topo_blocks = jnp.zeros((1, 1, 1), jnp.int32)

        device_ds = hasattr(dataset, "device_arrays")
        feat_host = cache_cfg.enabled and \
            cache_cfg.feature_residency == "host"
        topo_host = cache_cfg.enabled and cache_cfg.topo_residency == "host"
        host_indptr = host_indices = host_feats = None
        dev_feats = None

        def _hbm_access(csr):
            if scfg.neighbor_window:
                from legion_tpu.sampling.access import WindowedCSRAccess
                return WindowedCSRAccess.from_csr(csr,
                                                  scfg.neighbor_window)
            return DeviceCSRAccess(csr)

        if device_ds:
            assert not cache_cfg.enabled, (
                "host-cached storage needs a host dataset")
            self.csr, dev_feats, _ = dataset.device_arrays()
            base_access = _hbm_access(self.csr)
            degrees = self.csr.degrees()
        else:
            host_indptr = np.asarray(dataset.graph.indptr)
            host_indices = np.asarray(dataset.graph.indices)
            host_feats = np.ascontiguousarray(dataset.features, np.float32)
            if topo_host:
                # presampling reads adjacency from host memory, matching
                # the reference's UVA pre_sample (operator_impl.cu:301-397)
                self.csr = None
                base_access = CachedTopoAccess(
                    row_map=jnp.full((V,), -1, jnp.int32),
                    sub_indptr=jnp.zeros((2,), jnp.int64),
                    sub_indices=jnp.full((1,), -1, jnp.int32),
                    host_indptr=host_indptr, host_indices=host_indices)
                degrees = jnp.asarray(
                    (host_indptr[1:] - host_indptr[:-1]).astype(np.int32))
            else:
                self.csr = dataset.graph.to_device(rep)
                base_access = _hbm_access(self.csr)
                degrees = self.csr.degrees()

        Kg = self.mesh.shape["member"]
        want_compact = scfg.auto_compact and scfg.node_caps is None
        na = ea = None
        if cache_cfg.enabled or want_compact:
            steps = cache_cfg.presample_steps or self.schedule.train_step
            steps = max(1, min(steps, self.schedule.train_step))
            na, ea, mx = presample_hotness(
                self.sampler_t, base_access, self.train_bank[0], steps,
                jax.random.PRNGKey(config.train.seed + 17))
            if want_compact:
                mxv = np.asarray(mx)
                caps = [scfg.batch_size]
                for k in range(1, len(mxv)):
                    # configurable headroom over the presampled max (the
                    # reference uses 1.2x, server.cu:277 — see
                    # SamplerConfig.cap_headroom), rounded to lane multiples
                    c = max(int(mxv[k] * scfg.cap_headroom) + 8,
                            caps[-1] + 1)
                    caps.append(-(-c // 128) * 128)
                scfg = replace(scfg, node_caps=tuple(caps))
                self.sampler_t = NeighborSampler(scfg, V)
                self.compact_caps = tuple(caps)

        def _feat_cast(arr):
            # bf16 feature storage halves HBM residency and the hot
            # feature-gather bytes; aggregation accumulates in f32
            # (ops/hop_agg.py), matmuls promote, so training math holds
            if config.train.compute_dtype == "bfloat16":
                import jax.numpy as _jnp
                return arr.astype(_jnp.bfloat16) if hasattr(arr, "astype") \
                    else arr
            return arr

        # 128-column padding of the HBM feature table (pure-HBM residency
        # only; TrainConfig.pad_feature_dim): rows start on aligned
        # boundaries for the per-step row gather. Layer-0 weight pad rows
        # are zero, so training math is unchanged.
        F_log = meta.feature_dim
        self.feat_pad = -(-F_log // 128) * 128 \
            if config.train.pad_feature_dim and not cache_cfg.enabled \
            else F_log

        if not cache_cfg.enabled:
            self.graph_access = base_access
            if device_ds:
                df = _feat_cast(dev_feats)
                if self.feat_pad != F_log:
                    df = jnp.pad(df, ((0, 0), (0, self.feat_pad - F_log)))
                self.feature_source = DeviceFeatureSource(df)
            else:
                import ml_dtypes
                hf = host_feats if config.train.compute_dtype != "bfloat16" \
                    else host_feats.astype(ml_dtypes.bfloat16)
                if self.feat_pad != F_log:
                    hf = np.pad(hf, ((0, 0), (0, self.feat_pad - F_log)))
                self.feature_source = DeviceFeatureSource(
                    jax.device_put(hf, rep))
            return

        # topology hotness only matters if topology actually needs caching
        # bf16 cache storage doubles the rows a byte budget holds
        self._feat_dtype = "bfloat16" \
            if config.train.compute_dtype == "bfloat16" else "float32"
        bpf = 2 if self._feat_dtype == "bfloat16" else 4
        ea_eff = ea if topo_host else jnp.zeros_like(ea)
        na_eff = na if feat_host else jnp.zeros_like(na)
        plan = plan_cache(na_eff, ea_eff, degrees, cache_cfg.cache_bytes,
                          meta.feature_dim, cache_cfg.alpha_step,
                          group_size=Kg, bytes_per_feat=bpf)
        self.cache_plan = plan

        if self.n_dev > 1:
            self._setup_multidev_cache(plan, feat_host, topo_host,
                                       host_feats, host_indptr,
                                       host_indices, Kg, rep, scfg,
                                       _hbm_access)
            return
        cache = UnifiedCache.build_from_host(
            plan, host_feats if feat_host else None,
            host_indptr if topo_host else None,
            host_indices if topo_host else None, V,
            feat_dtype=self._feat_dtype)

        if topo_host:
            self.graph_access = CachedTopoAccess(
                cache.row_map if cache.row_map is not None
                else jnp.full((V,), -1, jnp.int32),
                cache.sub_indptr if cache.sub_indptr is not None
                else jnp.zeros((2,), jnp.int64),
                cache.sub_indices if cache.sub_indices is not None
                else jnp.full((1,), -1, jnp.int32),
                host_indptr, host_indices)
        else:
            self.graph_access = _hbm_access(self.csr)
        if feat_host:
            assert cache.slot_map is not None, (
                "feature cache budget resolved to zero rows")
            if cache_cfg.host_transfer == "staged":
                # miss rows cross host->device between two programs (no
                # in-program callback needed — see CacheConfig.host_transfer)
                assert self.n_dev == 1, (
                    "staged host-feature transfer is single-device; "
                    "multi-device host features use the clique cache")
                self._staged_host = True
                self._cache = cache
                self._host_feats = np.ascontiguousarray(
                    host_feats, np.float32)
                self.feature_source = None
            else:
                self.feature_source = CachedFeatureSource(cache, host_feats)
        else:
            self.feature_source = DeviceFeatureSource(
                jax.device_put(host_feats, rep))

    # ------------------------------------------------------------------
    def _setup_multidev_cache(self, plan, feat_host, topo_host, host_feats,
                              host_indptr, host_indices, Kg, rep, scfg,
                              _hbm_access) -> None:
        """Multi-device cache residency: clique-aggregated feature and
        topology caches over the "member" axis — the reference's
        NVLink-clique cache aggregation (cache.cu:375-389; feature
        interleave cache_impl.cuh:104-109, topology partition
        cache_impl.cuh:89-101 + graph_storage.cu:76-111). Across the
        "clique" axis the cache replicates: Kc independent groups.
        Misses fall back to host storage — pure_callback host draws/
        gathers, or the trainer's staged miss pipeline for features
        (CacheConfig.host_transfer)."""
        from legion_tpu.cache.collective import (
            CliqueFeatureCache, CliqueTopoCache, HostFallbackAccess,
            build_clique_cache, build_clique_topo)
        from legion_tpu.cache.unified_cache import (DeviceFeatureSource,
                                                    UnifiedCache)
        from legion_tpu.sampling.access import CachedTopoAccess
        mesh = self.mesh
        V = self.dataset.meta.num_nodes
        # billion-vertex graphs swap the replicated [V] id->slot tables
        # for HashMap32 (~32B per CACHED vertex; at uk2014 scale the two
        # direct tables alone would cost 6.3GB HBM per chip)
        map_impl = self.config.cache.resolve_map_impl(V)

        # --- topology residency ---
        if topo_host and Kg > 1 and plan.topo_capacity >= Kg:
            W = scfg.neighbor_window or 64
            row_map, mp, mi2, _ = build_clique_topo(
                np.asarray(plan.topo_order), plan.topo_capacity,
                host_indptr, host_indices, Kg, window=W,
                map_impl=map_impl)
            self.topo_pairs = jax.device_put(
                mp, NamedSharding(mesh, P("member", None, None)))
            self.topo_blocks = jax.device_put(
                mi2, NamedSharding(mesh, P("member", None, None)))
            if map_impl != "hash":
                row_map = jnp.asarray(row_map)
            self.graph_access = CliqueTopoCache(
                jax.device_put(row_map, rep), None, None,
                HostFallbackAccess(host_indptr, host_indices), Kg)
            self._use_clique_topo = True
        elif topo_host:
            # Kg == 1: each clique member caches its own hot sub-CSR
            # (replicated across cliques), host-callback fallback
            cache_t = UnifiedCache.build_from_host(
                plan, None, host_indptr, host_indices, V)
            self.graph_access = CachedTopoAccess(
                cache_t.row_map if cache_t.row_map is not None
                else jnp.full((V,), -1, jnp.int32),
                cache_t.sub_indptr if cache_t.sub_indptr is not None
                else jnp.zeros((2,), jnp.int64),
                cache_t.sub_indices if cache_t.sub_indices is not None
                else jnp.full((1,), -1, jnp.int32),
                host_indptr, host_indices)
        else:
            self.graph_access = _hbm_access(self.csr)

        # --- feature residency ---
        if feat_host:
            # clique-aggregated interleaved feature cache over the member
            # axis (degenerates to a per-device cache at Kg == 1)
            slot_map, member_rows, R = build_clique_cache(
                np.asarray(plan.feature_order), plan.feature_capacity,
                host_feats, Kg, feat_dtype=self._feat_dtype,
                map_impl=map_impl)
            self.member_rows = jax.device_put(
                member_rows,
                NamedSharding(mesh, P("member", None, None)))
            if map_impl != "hash":
                slot_map = jnp.asarray(slot_map)
            self.feature_source = CliqueFeatureCache(
                jax.device_put(slot_map, rep), host_feats,
                Kg, R)
            self._use_clique = True
            if self.config.cache.host_transfer == "staged":
                # miss rows cross host->device between program A and B;
                # the clique collective serves hits INSIDE program A (no
                # callbacks anywhere) — the multi-chip Legion scenario.
                # With HOST topology the sample program additionally
                # splits per hop (_make_staged_sample_chain).
                self._staged_host = True
                self._cache = None
                self._host_feats = np.ascontiguousarray(
                    host_feats, np.float32)
        else:
            self.feature_source = DeviceFeatureSource(
                jax.device_put(host_feats, rep))

    # ------------------------------------------------------------------
    def init_state(self, key: Optional[jax.Array] = None) -> Dict:
        if key is None:
            key = jax.random.PRNGKey(self.config.train.seed)
        rep = NamedSharding(self.mesh, P())
        dp = NamedSharding(self.mesh, self._DP)
        params = jax.device_put(self.model_t.init(key), rep)
        opt_state = jax.device_put(self.tx.init(params), rep)
        pos_map = jax.device_put(
            np.full((self.n_dev, self.sampler_t.state_size),
                    np.iinfo(np.int32).max, np.int32), dp)
        z = lambda: jax.device_put(np.int32(0), rep)
        mdt = np.float32 if getattr(self, "is_lp", False) else np.int32
        zm = lambda: jax.device_put(mdt(0), rep)
        state = {"params": params, "opt_state": opt_state,
                 "pos_map": pos_map, "train_ctr": z(), "valid_ctr": z(),
                 "test_ctr": z(), "correct": zm(), "total": zm(),
                 "base_key": jax.device_put(
                     jax.random.PRNGKey(self.config.train.seed + 1), rep)}
        return self.prime_carry(state)

    def prime_carry(self, state: Dict) -> Dict:
        """(Re)fill the inter-batch pipeline carry: sample + gather the
        batch at state's train_ctr (TrainConfig.interbatch). The carry is
        scratch — init_state and checkpoint restore call this; it is not
        saved."""
        if self._staged_host or not self.config.train.interbatch:
            return state
        pos_map, batch, x, hits = self._prime(
            state["pos_map"], state["train_ctr"], state["base_key"],
            self.train_bank, self.graph_access, self.feature_source,
            self.member_rows, self.topo_pairs, self.topo_blocks)
        return dict(state, pos_map=pos_map, carry_batch=batch, carry_x=x,
                    carry_hits=hits)

    # ------------------------------------------------------------------
    def _device_key(self, base_key: jax.Array, ctr: jax.Array,
                    tag: int) -> jax.Array:
        dev = jnp.int32(0)
        for a in self.axes:
            dev = dev * self.mesh.shape[a] + jax.lax.axis_index(a)
        k = jax.random.fold_in(base_key, ctr)
        k = jax.random.fold_in(k, tag)
        return jax.random.fold_in(k, dev)

    def _topo_hit_count(self, batch, access, sampler=None
                        ) -> Tuple[jax.Array, jax.Array]:
        """(hits, total) over the EXPANDED frontier prefix of the ids
        buffer — every vertex whose adjacency was read this batch (seeds +
        hops 0..L-2 occupy ids[:cum_caps[L-1]]). Counts vertices SERVED by
        the topology cache: resident in row_map, minus clique
        request-overflow lanes (round-3 review: counting overflow as hits
        hid clique-cache pathology under skew). The overflow correction
        replays the lookup's exact per-owner budget rule
        (collective._bucket_by_owner: lanes past R_req per owner fall back
        to the host path)."""
        from legion_tpu.cache.hashmap import map_lookup
        sampler = sampler or self.sampler_t
        L = sampler.config.num_hops
        row_map = getattr(access, "row_map", None)
        prefix = jax.lax.slice(batch.node_ids, (0,),
                               (sampler.cum_caps[L - 1],))
        pvalid = prefix >= 0
        total = jnp.sum(pvalid, dtype=jnp.int32)
        if row_map is None:
            return total, total    # all HBM-resident
        rm = map_lookup(row_map, prefix)
        hits = jnp.sum(rm >= 0, dtype=jnp.int32)
        Kg = getattr(access, "Kg", 1)
        slack = getattr(access, "slack", None)
        if Kg > 1 and slack is not None:
            # per-hop: count resident lanes per owning member; lanes
            # beyond the fixed request budget R_req were NOT served
            for k in range(L):
                F_k = sampler.frontier_sizes[k]
                R_req = int(-(-F_k * slack // Kg))
                fr = jax.lax.dynamic_slice(
                    batch.node_ids, (batch.hop_offsets[k],), (F_k,))
                rmk = map_lookup(row_map, fr)
                owner = jnp.where(rmk >= 0, rmk % Kg, Kg)
                cnt = jnp.sum(owner[:, None] ==
                              jnp.arange(Kg, dtype=jnp.int32)[None, :],
                              axis=0, dtype=jnp.int32)
                hits -= jnp.sum(jnp.maximum(cnt - R_req, 0),
                                dtype=jnp.int32)
        return hits, total

    def _build_train_step(self):
        sampler, model, tx = self.sampler_t, self.model_t, self.tx
        bs = self.config.sampler.batch_size
        n_steps = self.schedule.train_step

        use_clique = self._use_clique
        use_clique_topo = self._use_clique_topo

        def _sample_fetch(access, bank, pos_map, ctr, base_key, fsource,
                          member_rows):
            """Sample batch `ctr` + gather its features (DMA stream)."""
            lid = ctr % n_steps
            seeds = jax.lax.dynamic_slice(bank, (lid * bs,), (bs,))
            k = self._device_key(base_key, ctr, 0)
            batch, pos_map = sampler.sample_fn(access, seeds, pos_map, k)
            # fetch only the model-visible id prefix; the ids buffer's
            # frontier-slack tail never feeds a layer
            nid = jax.lax.slice(batch.node_ids, (0,), (sampler.max_ids,))
            if use_clique:
                x, feat_hits = fsource.fetch(nid, member_rows[0])
            else:
                x, feat_hits = fsource.fetch(nid)
            return batch, x, jax.lax.psum(feat_hits, self.axes), pos_map

        def _train_on(params, opt_state, batch, x, ctr, base_key, bank,
                      ybank):
            """fwd/bwd/update on batch `ctr` (compute stream)."""
            lid = ctr % n_steps
            seeds = jax.lax.dynamic_slice(bank, (lid * bs,), (bs,))
            k = self._device_key(base_key, ctr, 0)
            y = jax.lax.dynamic_slice(ybank, (lid * bs,), (bs,))
            valid = seeds >= 0
            if self.is_lp:
                def loss_fn(p):
                    return model.loss(p, x, batch, valid, train=True,
                                      rng=jax.random.fold_in(k, 7))
            else:
                def loss_fn(p):
                    logits = model.apply(p, x, batch, train=True,
                                         rng=jax.random.fold_in(k, 7))
                    return _masked_ce(logits, y, valid)
            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = jax.lax.pmean(grads, self.axes)
            loss = jax.lax.pmean(loss, self.axes)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        def _counters(batch, access):
            # per-step counters for StepMetrics (the live PCM analog,
            # monitor.cuh:83-135 role): trained edges, fetched id slots,
            # adjacency reads served by the topology cache
            nid = jax.lax.slice(batch.node_ids, (0,), (sampler.max_ids,))
            edges = jnp.sum(batch.num_edges, dtype=jnp.int32)
            slots = jnp.sum(nid >= 0, dtype=jnp.int32)
            th, tt = self._topo_hit_count(batch, access)
            return (jax.lax.psum(edges, self.axes),
                    jax.lax.psum(slots, self.axes),
                    jax.lax.psum(th, self.axes),
                    jax.lax.psum(tt, self.axes))

        mr_spec = P("member", None, None) if use_clique else P()
        tp_spec = P("member", None, None) if use_clique_topo else P()
        DP = self._DP

        if self.config.train.interbatch:
            # pipelined: train on the CARRIED batch `ctr` while sampling +
            # gathering batch ctr+1 — independent streams XLA overlaps
            # (TrainConfig.interbatch; exact same math and RNG sequence)
            def step(params, opt_state, pos_map, ctr, base_key, bank,
                     access, fsource, member_rows, topo_pairs, topo_blocks,
                     ybank, c_batch, c_x, c_hits):
                pos_map, bank = pos_map[0], bank[0]
                if use_clique_topo:
                    access = access.bind_shard(topo_pairs[0],
                                               topo_blocks[0])
                c_batch = jax.tree.map(lambda a: a[0], c_batch)
                c_x = c_x[0]
                params, opt_state, loss = _train_on(
                    params, opt_state, c_batch, c_x, ctr, base_key, bank,
                    ybank[0])
                batch2, x2, hits2, pos_map = _sample_fetch(
                    access, bank, pos_map, ctr + 1, base_key, fsource,
                    member_rows)
                edges, slots, th, tt = _counters(c_batch, access)
                return (params, opt_state, pos_map[None], ctr + 1, loss,
                        c_hits, edges, slots, th, tt,
                        jax.tree.map(lambda a: a[None], batch2), x2[None],
                        hits2)

            sm = _shard_map(
                step, self.mesh,
                in_specs=(P(), P(), DP, P(), P(), self._DPN, P(), P(),
                          mr_spec, tp_spec, tp_spec, self._DPN, DP, DP,
                          P()),
                out_specs=(P(), P(), DP, P(), P(), P(), P(), P(), P(),
                           P(), DP, DP, P()))
            # NOTE: the carry args (12, 13) are deliberately NOT donated —
            # aliasing batch N+1's gather output onto the buffer batch N's
            # train half still reads creates a false RAW hazard that
            # serializes the two streams
            jitted = jax.jit(sm, donate_argnums=(0, 1, 2, 3))

            # the prime program fills the first carry (batch `ctr`)
            def prime(pos_map, ctr, base_key, bank, access, fsource,
                      member_rows, topo_pairs, topo_blocks):
                pos_map, bank = pos_map[0], bank[0]
                if use_clique_topo:
                    access = access.bind_shard(topo_pairs[0],
                                               topo_blocks[0])
                batch, x, hits, pos_map = _sample_fetch(
                    access, bank, pos_map, ctr, base_key, fsource,
                    member_rows)
                return (pos_map[None],
                        jax.tree.map(lambda a: a[None], batch), x[None],
                        hits)

            psm = _shard_map(
                prime, self.mesh,
                in_specs=(DP, P(), P(), self._DPN, P(), P(), mr_spec,
                          tp_spec, tp_spec),
                out_specs=(DP, DP, DP, P()))
            self._prime = jax.jit(psm, donate_argnums=(0,))
            return jitted

        fused = max(int(self.config.train.fused_steps), 1)

        def step(params, opt_state, pos_map, ctr, base_key, bank, access,
                 fsource, member_rows, topo_pairs, topo_blocks, ybank):
            pos_map, bank = pos_map[0], bank[0]
            if use_clique_topo:
                access = access.bind_shard(topo_pairs[0], topo_blocks[0])

            def one(params, opt_state, pos_map, ctr):
                batch, x, feat_hits, pos_map = _sample_fetch(
                    access, bank, pos_map, ctr, base_key, fsource,
                    member_rows)
                params, opt_state, loss = _train_on(
                    params, opt_state, batch, x, ctr, base_key, bank,
                    ybank[0])
                edges, slots, th, tt = _counters(batch, access)
                return params, opt_state, pos_map, ctr + 1, loss, \
                    feat_hits, edges, slots, th, tt

            if fused == 1:
                (params, opt_state, pos_map, ctr, loss, feat_hits, edges,
                 slots, th, tt) = one(params, opt_state, pos_map, ctr)
            else:
                # K steps per dispatch (TrainConfig.fused_steps): identical
                # math/RNG to K single-step calls — the loop only amortizes
                # the per-dispatch host round-trip
                def body(carry, _):
                    p, o, pm, c = carry
                    p, o, pm, c, loss, fh, ed, sl, th, tt = one(p, o, pm, c)
                    return (p, o, pm, c), (loss, fh, ed, sl, th, tt)

                (params, opt_state, pos_map, ctr), ys = jax.lax.scan(
                    body, (params, opt_state, pos_map, ctr), None,
                    length=fused)
                loss = jnp.mean(ys[0])
                feat_hits, edges, slots, th, tt = (
                    jnp.sum(y, dtype=y.dtype) for y in ys[1:])
            return params, opt_state, pos_map[None], ctr, loss, \
                feat_hits, edges, slots, th, tt

        sm = _shard_map(
            step, self.mesh,
            in_specs=(P(), P(), DP, P(), P(), self._DPN, P(), P(),
                      mr_spec, tp_spec, tp_spec, self._DPN),
            out_specs=(P(), P(), DP, P(), P(), P(), P(), P(), P(),
                       P()))
        return jax.jit(sm, donate_argnums=(0, 1, 2, 3))

    def _build_eval_step(self, n_steps: int, ctr_name: str):
        sampler, model = self.sampler_e, self.model_e
        bs = self.config.sampler.eval_batch_size

        use_clique = self._use_clique
        use_clique_topo = self._use_clique_topo

        def step(params, pos_map, ctr, correct, total, base_key, bank,
                 access, fsource, member_rows, topo_pairs, topo_blocks,
                 ybank):
            pos_map, bank, ybank = pos_map[0], bank[0], ybank[0]
            if use_clique_topo:
                access = access.bind_shard(topo_pairs[0], topo_blocks[0])
            lid = ctr % n_steps
            seeds = jax.lax.dynamic_slice(bank, (lid * bs,), (bs,))
            k = self._device_key(base_key, ctr, 1)
            batch, pos_map = sampler.sample_fn(access, seeds, pos_map, k)
            nid = jax.lax.slice(batch.node_ids, (0,), (sampler.max_ids,))
            if use_clique:
                x, _ = fsource.fetch(nid, member_rows[0])
            else:
                x, _ = fsource.fetch(nid)
            y = jax.lax.dynamic_slice(ybank, (lid * bs,), (bs,))
            valid = seeds >= 0
            if self.is_lp:
                # validation metric is mean link-prediction loss, like the
                # reference's valid_one_step (lp_sage.py:99-115,206-215)
                loss = model.loss(params, x, batch, valid, train=False)
                t = jnp.sum(valid[: bs // 3], dtype=jnp.int32)
                c = loss * t.astype(jnp.float32)
                c = jax.lax.psum(c, self.axes)
                t = jax.lax.psum(t, self.axes)
                return pos_map[None], ctr + 1, correct + c, \
                    total + t.astype(jnp.float32)
            logits = model.apply(params, x, batch, train=False)
            pred = jnp.argmax(logits, axis=-1)
            c = jnp.sum((pred == y) & valid, dtype=jnp.int32)
            t = jnp.sum(valid, dtype=jnp.int32)
            c = jax.lax.psum(c, self.axes)
            t = jax.lax.psum(t, self.axes)
            return pos_map[None], ctr + 1, correct + c, total + t

        mr_spec = P("member", None, None) if use_clique else P()
        tp_spec = P("member", None, None) if use_clique_topo else P()
        sm = _shard_map(
            step, self.mesh,
            in_specs=(P(), self._DP, P(), P(), P(), P(), self._DPN, P(), P(),
                      mr_spec, tp_spec, tp_spec, self._DPN),
            out_specs=(self._DP, P(), P(), P()))
        jitted = jax.jit(sm, donate_argnums=(1, 2, 3, 4))

        def run(state: Dict, bank, ybank) -> Dict:
            pos_map, ctr, correct, total = jitted(
                state["params"], state["pos_map"], state[ctr_name],
                state["correct"], state["total"], state["base_key"], bank,
                self.graph_access, self.feature_source, self.member_rows,
                self.topo_pairs, self.topo_blocks, ybank)
            return dict(state, pos_map=pos_map, correct=correct,
                        total=total, **{ctr_name: ctr})

        return run

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # Staged host-feature path (CacheConfig.host_transfer == "staged"):
    # the split-program pipeline — program A (sample +
    # cache lookup + miss compaction), C++ host gather, program B
    # (assemble + train). Owned by pipeline.staged.StagedHostPipeline;
    # the thin seams below exist so tests can patch the probe and reach
    # the caps through the Trainer.

    _shard_map = staticmethod(_shard_map)

    def _build_staged_steps(self) -> None:
        from legion_tpu.pipeline.staged import StagedHostPipeline
        StagedHostPipeline(self)          # assigns self._staged
        self._eval_steps = self._staged.eval_steps

    def _probe_miss_cap(self) -> int:
        return self._staged.probe_miss_cap()

    def _probe_eval_miss_cap(self) -> int:
        return self._staged.probe_eval_miss_cap()

    @property
    def _miss_cap(self) -> int:
        return self._staged.miss_cap

    @property
    def _eval_miss_cap(self) -> int:
        return self._staged.eval_miss_cap

    @property
    def _staged_clique(self) -> bool:
        return self._staged.staged_clique

    @property
    def _miss_overflows(self) -> int:
        return self._staged.miss_overflows

    @property
    def _eval_miss_overflows(self) -> int:
        return self._staged.eval_miss_overflows

    def _staged_train_step(self, state: Dict) -> Tuple[Dict, jax.Array]:
        return self._staged.train_step(state)

    def close(self) -> None:
        """Tear down the staged pipeline (cancel the pending prefetch and
        stop the gather worker). Safe to call multiple times."""
        st = getattr(self, "_staged", None)
        if st is not None:
            st.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def train_step(self, state: Dict) -> Tuple[Dict, jax.Array]:
        if self._staged_host:
            return self._staged_train_step(state)
        if self.config.train.interbatch:
            (params, opt_state, pos_map, ctr, loss, feat_hits, edges,
             slots, topo_hits, topo_total, c_batch, c_x,
             c_hits) = self._train_step(
                state["params"], state["opt_state"], state["pos_map"],
                state["train_ctr"], state["base_key"], self.train_bank,
                self.graph_access, self.feature_source, self.member_rows,
                self.topo_pairs, self.topo_blocks, self.train_ybank,
                state["carry_batch"], state["carry_x"],
                state["carry_hits"])
            extra = dict(carry_batch=c_batch, carry_x=c_x,
                         carry_hits=c_hits)
        else:
            (params, opt_state, pos_map, ctr, loss, feat_hits, edges,
             slots, topo_hits, topo_total) = self._train_step(
                state["params"], state["opt_state"], state["pos_map"],
                state["train_ctr"], state["base_key"], self.train_bank,
                self.graph_access, self.feature_source, self.member_rows,
                self.topo_pairs, self.topo_blocks, self.train_ybank)
            extra = {}
        self.last_feat_hits = feat_hits
        self.last_edges = edges
        self.last_slots = slots
        self.last_topo_hits = topo_hits
        self.last_topo_total = topo_total
        return dict(state, params=params, opt_state=opt_state,
                    pos_map=pos_map, train_ctr=ctr, **extra), loss

    def _reset_metrics(self, state: Dict) -> Dict:
        # two distinct buffers — both are donated by the eval step
        rep = NamedSharding(self.mesh, P())
        dt = jnp.float32 if self.is_lp else jnp.int32
        return dict(state,
                    correct=jax.device_put(jnp.zeros((), dt), rep),
                    total=jax.device_put(jnp.zeros((), dt) + 0, rep))

    def run_eval(self, state: Dict, mode: Mode) -> Tuple[Dict, float]:
        state = self._reset_metrics(state)
        bank = self.valid_bank if mode == Mode.VALID else self.test_bank
        ybank = self.valid_ybank if mode == Mode.VALID else self.test_ybank
        n = self.schedule.valid_step if mode == Mode.VALID \
            else self.schedule.test_step
        stepper = self._eval_steps[mode]
        for _ in range(n):
            state = stepper(state, bank, ybank)
        acc = float(state["correct"]) / max(float(state["total"]), 1.0)
        return state, acc

    # ------------------------------------------------------------------
    def fit(self, state: Optional[Dict] = None, verbose: bool = True,
            checkpoint_dir: str = "", checkpoint_every: int = 0
            ) -> Tuple[Dict, List[EpochStats]]:
        """Run the full reference schedule: per epoch train then valid;
        test once at the end (ipc_service.cu:213-253). Prints epoch wall
        time and accuracies like legion_graphsage.py:158-180.
        checkpoint_every > 0 saves to checkpoint_dir every N epochs."""
        from legion_tpu.utils.metrics import StepMetrics
        if state is None:
            state = self.init_state()
        sch = self.schedule
        stats: List[EpochStats] = []
        self.epoch_metrics: List[StepMetrics] = []
        cache_on = self._use_clique or self.cache_plan is not None
        fused = 1 if (self._staged_host or self.config.train.interbatch) \
            else max(int(self.config.train.fused_steps), 1)
        if fused > 1:
            assert sch.train_step % fused == 0, (
                f"fused_steps={fused} must divide the epoch's "
                f"train_step={sch.train_step} for the exact schedule")
        for epoch in range(sch.epochs):
            t0 = time.time()
            losses, hits, edges, slots = [], [], [], []
            sm = StepMetrics(feat_dim=self.dataset.meta.feature_dim)
            for _ in range(sch.train_step // fused):
                state, loss = self.train_step(state)
                losses.append(loss)
                hits.append(self.last_feat_hits)
                edges.append(self.last_edges)
                slots.append(self.last_slots)
            train_loss = float(jnp.mean(jnp.stack(losses))) if losses \
                else float("nan")
            # per-step counters come off-device once per epoch (the live
            # replacement for the reference's disabled PCM monitor,
            # monitor.cuh:83-135: bytes served by cache vs fetched host-side)
            if losses:
                tot = jnp.stack([jnp.stack(hits), jnp.stack(edges),
                                 jnp.stack(slots)]).sum(axis=1)
                th, te, ts = (int(v) for v in np.asarray(tot))
                sm.steps = len(losses) * fused
                sm.edges, sm.feat_hits = te, th
                sm.nodes = sm.feat_total = ts
                if not cache_on:
                    sm.feat_hits = ts   # all slots served from HBM
            sm.stop()
            state, acc = self.run_eval(state, Mode.VALID)
            dt = time.time() - t0
            stats.append(EpochStats(epoch, train_loss, acc, dt))
            self.epoch_metrics.append(sm)
            if verbose:
                hit_info = (f" | hit rate {sm.hit_rate:.3f} | host "
                            f"{sm.host_bytes / 1e6:.1f}MB") if cache_on \
                    else ""
                print(f"Epoch {epoch:03d} | time {dt:.2f}s | "
                      f"loss {train_loss:.4f} | val acc {acc:.4f} | "
                      f"{sm.edges_per_s / 1e6:.1f}M edges/s | "
                      f"{sm.nodes_per_s / 1e6:.1f}M nodes/s{hit_info}")
            if checkpoint_dir and checkpoint_every > 0 and \
                    (epoch + 1) % checkpoint_every == 0:
                from legion_tpu.utils import save_checkpoint
                save_checkpoint(checkpoint_dir, state,
                                int(state["train_ctr"]))
        state, self.test_acc = self.run_eval(state, Mode.TEST)
        if verbose:
            print(f"Test acc {self.test_acc:.4f}")
        return state, stats
