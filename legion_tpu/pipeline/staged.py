"""Staged host-feature pipeline: the split-program path.

The reference streams cache-miss feature rows over zero-copy UVA inside
its kernels (cache_impl.cuh:239-272); instead of an in-program host
callback (host_transfer="callback") this path splits the step:

    [sample + cache lookup + miss compaction]   (device program A)
    C++ parallel host gather of the compacted miss rows + device_put
    [assemble features + fwd/bwd + update]      (device program B)

The miss buffer's static width comes from an epoch-wide probe pass (the
reference presamples max sizes over the whole epoch, server.cu:275-283);
a rare batch overflowing the cap DROPS the tail misses (zero rows) like
every other overflow in the system — no mid-training recompile.

Inter-batch overlap (INTERBATCH_CON=2, system_config.cuh:47): program A
for step N+1 is dispatched before step N's host gather, so the device
runs [A_{N+1}, B_N] while the host gathers N+1's rows.

With HOST-resident topology the sample program additionally splits per
hop (`_make_sample_chain`): device draws from the clique topo cache /
hot sub-CSR, C++ host neighbor draws for the misses between programs —
the reference's UVA miss branch (operator_impl.cu:224-243).

This class owns every staged-only artifact (compiled programs, miss
caps, the prefetch future, the gather worker); `Trainer` delegates to it
when `CacheConfig.host_transfer` is "staged". Interface:
``train_step(state)``, ``eval_steps[mode](state, bank, ybank)``,
``miss_cap``/``eval_miss_cap``, ``close()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from legion_tpu.pipeline.schedule import Mode
# not circular: this module is imported lazily by
# Trainer._build_staged_steps, after legion_tpu.train finishes loading
from legion_tpu.train import _masked_ce


class StagedHostPipeline:
    """Compiled program chain + host gather worker for staged transfer."""

    def __init__(self, trainer) -> None:
        from concurrent.futures import ThreadPoolExecutor
        self.t = trainer
        # visible to the trainer DURING construction: the miss-cap probes
        # run through trainer._probe_miss_cap (test seam) which delegates
        # back here
        trainer._staged = self
        self._shard_map = trainer._shard_map
        sch = trainer.schedule
        # cache lookup mode inside program A: direct slot table (single
        # device, UnifiedCache) or the clique collective (multi-device)
        self.staged_clique = trainer._use_clique
        self._lookup = trainer.feature_source if trainer._use_clique \
            else trainer._cache.slot_map
        map_impl = trainer.config.cache.resolve_map_impl(
            trainer.dataset.meta.num_nodes)
        if not trainer._use_clique and map_impl == "hash":
            # billion-vertex fallback: O(cached) hash instead of the O(V)
            # direct table (the BGHT role, cache.cu:71-88)
            from legion_tpu.cache.hashmap import HashMap32
            cap = trainer.cache_plan.feature_capacity
            qf = np.asarray(trainer.cache_plan.feature_order[:cap],
                            np.int64)
            self._lookup = HashMap32.build(
                qf, np.arange(cap, dtype=np.int32))
        bs_t = trainer.config.sampler.batch_size
        self._sample_train = self._make_sample(
            trainer.sampler_t, sch.train_step, bs_t, tag=0)
        bs_e = trainer.config.sampler.eval_batch_size
        self._sample_eval = self._make_sample(
            trainer.sampler_e, max(sch.valid_step, 1), bs_e, tag=1)
        self._sample_eval_test = self._make_sample(
            trainer.sampler_e, max(sch.test_step, 1), bs_e, tag=1)
        # pipeline-owned sampler state: the train sample chain donates and
        # re-emits this buffer; eval keeps using state["pos_map"] — safe
        # because every sample fully clears its marks (ClearPosMap), so all
        # post-sample maps are content-equivalent
        self._pm = jax.device_put(
            np.full((trainer.n_dev, trainer.sampler_t.state_size),
                    np.iinfo(np.int32).max, np.int32),
            NamedSharding(trainer.mesh, trainer._DP))
        self.miss_cap = trainer._probe_miss_cap()
        self.eval_miss_cap = trainer._probe_eval_miss_cap()
        # overflow observability (round-2 advisor): a batch whose misses
        # exceed the probed cap gets zero rows for the dropped tail; count
        # and warn so silent accuracy degradation is visible
        self.miss_overflows = 0
        self.eval_miss_overflows = 0
        self._train_core = self._make_train_core(self.miss_cap)
        # one-step sample lookahead (the reference's INTERBATCH_CON=2
        # producer/consumer pipeline, system_config.cuh:47): device runs
        # [A_{N+1}, B_N] while a worker thread host-gathers step N+1's rows
        self._gather_pool = ThreadPoolExecutor(max_workers=1)
        self._prefetch: Optional[Tuple] = None  # (ctr, outs, gather future)
        self._ctr = 0
        self.eval_steps = {
            Mode.VALID: self._make_eval(Mode.VALID, "valid_ctr"),
            Mode.TEST: self._make_eval(Mode.TEST, "test_ctr"),
        }

    # -- program A ------------------------------------------------------
    def _feature_tail(self, sampler, batch, access_b, lookup, member_rows):
        """Shared tail of program A: feature cache lookup + miss
        compaction + per-step counters (runs per device inside
        shard_map). Returns the staged sample's per-device outputs."""
        t = self.t
        M = sampler.max_ids
        imax = jnp.iinfo(jnp.int32).max
        nid = jax.lax.slice(batch.node_ids, (0,), (M,))
        if self.staged_clique:
            rows, hit = lookup.fetch_cached(nid, member_rows[0])
            payload = rows
            miss = (nid >= 0) & ~hit
            hits = jnp.sum(hit, dtype=jnp.int32)
        else:
            slot = jnp.where(
                nid >= 0,
                lookup[jnp.clip(nid, 0, lookup.shape[0] - 1)], -1)
            payload = slot
            miss = (nid >= 0) & (slot < 0)
            hits = jnp.sum(slot >= 0, dtype=jnp.int32)
        lane = jnp.arange(M, dtype=jnp.int32)
        mkey = jnp.where(miss, lane, imax)
        sk, m_ids, m_pos = jax.lax.sort((mkey, nid, lane), dimension=0,
                                        num_keys=1)
        mvalid = sk != imax
        m_ids = jnp.where(mvalid, m_ids, -1)
        m_pos = jnp.where(mvalid, m_pos, -1)
        n_miss = jnp.sum(miss, dtype=jnp.int32)
        edges = jnp.sum(batch.num_edges, dtype=jnp.int32)
        topo_hits, topo_total = t._topo_hit_count(batch, access_b, sampler)
        return (batch, payload, m_ids, m_pos, n_miss, hits, edges,
                topo_hits, topo_total)

    def _make_sample(self, sampler, n_steps: int, bs: int, tag: int):
        """Program A, shard_map'd over the mesh: sample + cache lookup +
        miss compaction on every device. The cache lookup is the direct
        slot-table gather (single device / UnifiedCache) or the clique
        collective (CliqueFeatureCache.fetch_cached — requests ride
        NVLink, NO callbacks). Per-device miss ids come back to the host for the
        staged gather.

        When topology is host-resident (graph_access.needs_host_draws),
        sampling itself needs host neighbor draws; the single program is
        replaced by the per-hop chain (_make_sample_chain)."""
        t = self.t
        if getattr(t.graph_access, "needs_host_draws", False):
            return self._make_sample_chain(sampler, n_steps, bs, tag)
        clique = self.staged_clique
        use_clique_topo = t._use_clique_topo

        def sample(pos_map, ctr, base_key, bank, access, lookup,
                   member_rows, topo_pairs, topo_blocks):
            pos_map, bank = pos_map[0], bank[0]
            if use_clique_topo:
                access_b = access.bind_shard(topo_pairs[0], topo_blocks[0])
            else:
                access_b = access
            lid = ctr % n_steps
            seeds = jax.lax.dynamic_slice(bank, (lid * bs,), (bs,))
            k = t._device_key(base_key, ctr, tag)
            batch, pos_map = sampler.sample_fn(access_b, seeds, pos_map, k)
            (batch, payload, m_ids, m_pos, n_miss, hits, edges,
             topo_hits, topo_total) = self._feature_tail(
                sampler, batch, access_b, lookup, member_rows)
            batch = jax.tree.map(lambda a: a[None], batch)
            return (batch, pos_map[None], seeds[None], payload[None],
                    m_ids[None], m_pos[None], n_miss[None],
                    jax.lax.psum(hits, t.axes),
                    jax.lax.psum(edges, t.axes),
                    jax.lax.psum(topo_hits, t.axes),
                    jax.lax.psum(topo_total, t.axes))

        mr_spec = P("member", None, None) if clique else P()
        tp_spec = P("member", None, None) if use_clique_topo else P()
        DP = t._DP
        sm = self._shard_map(
            sample, t.mesh,
            in_specs=(DP, P(), P(), t._DPN, P(), P(), mr_spec, tp_spec,
                      tp_spec),
            out_specs=(DP, DP, DP, DP, DP, DP, DP, P(), P(), P(), P()))
        return jax.jit(sm, donate_argnums=(0,))

    def _make_sample_chain(self, sampler, n_steps: int, bs: int, tag: int):
        """Per-hop program splits for HOST-resident topology under staged
        transfer — the configuration of a real multi-card billion-edge
        run where neither topology nor features fit HBM. The reference
        serves these reads inside its kernels over zero-copy UVA
        (operator_impl.cu:224-243); without in-program callbacks the
        sample becomes a chain:

          A_0: seeds + hop-0 device draws (clique topo collective / hot
               sub-CSR) + compacted miss frontier        [device]
          host neighbor draws for hop-0 misses           [C++ sampler]
          A_k: merge hop k-1 draws, dedup, hop-k device draws + misses
          ...
          A_L: merge last draws, finish batch, feature cache lookup +
               miss compaction                           [device]

        RNG consumption matches the callback path op-for-op (the same
        host_seed the callback would pass), so chain and callback runs
        are loss-identical (tests/test_staged_host.py). Returns a
        blocking callable with the one-program sample's signature."""
        t = self.t
        L = sampler.config.num_hops
        fanouts = sampler.config.fanouts
        clique = self.staged_clique
        use_clique_topo = t._use_clique_topo
        mr_spec = P("member", None, None) if clique else P()
        tp_spec = P("member", None, None) if use_clique_topo else P()
        DP, DPN = t._DP, t._DPN
        dp1 = lambda tr: jax.tree.map(lambda a: a[None], tr)

        def _bind(access, topo_pairs, topo_blocks):
            if use_clique_topo:
                return access.bind_shard(topo_pairs[0], topo_blocks[0])
            return access

        def _hop_out(access_b, carry, k, ctr, base_key):
            frontier = sampler.hop_frontier(carry, k)
            hop_key = jax.random.fold_in(
                t._device_key(base_key, ctr, tag), k)
            lanes, served = access_b.lookup(frontier, fanouts[k], hop_key)
            miss_f = jnp.where(served, -1, frontier)
            return (dp1(carry), lanes[None], served[None], miss_f[None],
                    access_b.host_seed(hop_key)[None])

        def p0(pos_map, ctr, base_key, bank, access, topo_pairs,
               topo_blocks):
            pos_map, bank = pos_map[0], bank[0]
            access_b = _bind(access, topo_pairs, topo_blocks)
            lid = ctr % n_steps
            seeds = jax.lax.dynamic_slice(bank, (lid * bs,), (bs,))
            carry = sampler.begin(seeds, pos_map)
            return _hop_out(access_b, carry, 0, ctr, base_key) \
                + (seeds[None],)

        p0_j = jax.jit(self._shard_map(
            p0, t.mesh,
            in_specs=(DP, P(), P(), DPN, P(), tp_spec, tp_spec),
            out_specs=(DP, DP, DP, DP, DP, DP)), donate_argnums=(0,))

        def pk(k):
            def body(carry, lanes, served, host_nbr, ctr, base_key,
                     access, topo_pairs, topo_blocks):
                carry = jax.tree.map(lambda a: a[0], carry)
                access_b = _bind(access, topo_pairs, topo_blocks)
                cand = access_b.merge_draws(lanes[0], served[0],
                                            host_nbr[0], fanouts[k - 1])
                carry = sampler.hop_absorb(carry, k - 1, cand)
                return _hop_out(access_b, carry, k, ctr, base_key)

            return jax.jit(self._shard_map(
                body, t.mesh,
                in_specs=(DP, DP, DP, DP, P(), P(), P(), tp_spec,
                          tp_spec),
                out_specs=(DP, DP, DP, DP, DP)), donate_argnums=(0,))

        pk_j = [pk(k) for k in range(1, L)]

        def pl(carry, lanes, served, host_nbr, seeds, access, lookup,
               member_rows, topo_pairs, topo_blocks):
            carry = jax.tree.map(lambda a: a[0], carry)
            access_b = _bind(access, topo_pairs, topo_blocks)
            cand = access_b.merge_draws(lanes[0], served[0], host_nbr[0],
                                        fanouts[L - 1])
            carry = sampler.hop_absorb(carry, L - 1, cand)
            batch, pos_map = sampler.finish(carry)
            (batch, payload, m_ids, m_pos, n_miss, hits, edges,
             topo_hits, topo_total) = self._feature_tail(
                sampler, batch, access_b, lookup, member_rows)
            batch = jax.tree.map(lambda a: a[None], batch)
            return (batch, pos_map[None], seeds, payload[None],
                    m_ids[None], m_pos[None], n_miss[None],
                    jax.lax.psum(hits, t.axes),
                    jax.lax.psum(edges, t.axes),
                    jax.lax.psum(topo_hits, t.axes),
                    jax.lax.psum(topo_total, t.axes))

        pl_j = jax.jit(self._shard_map(
            pl, t.mesh,
            in_specs=(DP, DP, DP, DP, DP, P(), P(), mr_spec, tp_spec,
                      tp_spec),
            out_specs=(DP, DP, DP, DP, DP, DP, DP, P(), P(), P(), P())),
            donate_argnums=(0,))

        def host_draws(miss_f, hseed, fanout: int) -> jax.Array:
            mf = np.asarray(miss_f)                 # [n_dev, F_k]
            sd = np.asarray(hseed)                  # [n_dev]
            out = np.stack([
                t.graph_access.host_draw(mf[d], fanout, int(sd[d]))
                for d in range(t.n_dev)])           # [n_dev, F_k, fo]
            return jax.device_put(
                out, NamedSharding(t.mesh, P(t.axes, None, None)))

        def chain(pos_map, ctr, base_key, bank, access, lookup,
                  member_rows, topo_pairs, topo_blocks):
            carry, lanes, served, miss_f, hseed, seeds = p0_j(
                pos_map, ctr, base_key, bank, access, topo_pairs,
                topo_blocks)
            for k in range(1, L):
                nbr = host_draws(miss_f, hseed, fanouts[k - 1])
                carry, lanes, served, miss_f, hseed = pk_j[k - 1](
                    carry, lanes, served, nbr, ctr, base_key, access,
                    topo_pairs, topo_blocks)
            nbr = host_draws(miss_f, hseed, fanouts[L - 1])
            return pl_j(carry, lanes, served, nbr, seeds, access, lookup,
                        member_rows, topo_pairs, topo_blocks)

        return chain

    # -- miss-cap probes ------------------------------------------------
    def probe_miss_cap(self) -> int:
        """Measure worst-case cache misses over (up to) a full epoch of
        batches and size the static miss buffer at 1.2x — the reference's
        epoch-wide presample sizing rule (server.cu:275-283). Batches are
        cheap here: only program A runs, no features move."""
        t = self.t
        M = t.sampler_t.max_ids
        probes = min(t.schedule.train_step, 64)
        worst = 0
        key = jax.random.PRNGKey(t.config.train.seed + 1)
        counts = []
        for i in range(probes):
            out = self._sample_train(self._pm, jnp.int32(i), key,
                                     t.train_bank, t.graph_access,
                                     self._lookup, t.member_rows,
                                     t.topo_pairs, t.topo_blocks)
            self._pm = out[1]
            counts.append(out[6])
        for c in counts:
            worst = max(worst, int(np.asarray(c).max()))
        cap = int(worst * 1.2) + 256
        return min(M, -(-cap // 512) * 512)

    def probe_eval_miss_cap(self) -> int:
        """Same sizing rule for the eval sampler's miss buffer (round-1
        advisor: eval gathered the full max_ids-wide buffer per step).
        Probes BOTH the valid and test banks (round-2 advisor: the cap is
        applied to test eval too) and takes the max. 64 probe batches per
        bank (round-3 review: the earlier 8-batch probe at 1.5x headroom
        under-sampled the miss distribution's tail)."""
        t = self.t
        M = t.sampler_e.max_ids
        worst = 0
        key = jax.random.PRNGKey(t.config.train.seed + 1)
        for bank, n_steps, fn in (
                (t.valid_bank, t.schedule.valid_step, self._sample_eval),
                (t.test_bank, t.schedule.test_step,
                 self._sample_eval_test)):
            pm = jax.device_put(
                np.full((t.n_dev, t.sampler_e.state_size),
                        np.iinfo(np.int32).max, np.int32),
                NamedSharding(t.mesh, t._DP))
            for i in range(min(max(n_steps, 1), 64)):
                out = fn(pm, jnp.int32(i), key, bank, t.graph_access,
                         self._lookup, t.member_rows, t.topo_pairs,
                         t.topo_blocks)
                pm = out[1]
                worst = max(worst, int(np.asarray(out[6]).max()))
        cap = int(worst * 1.5) + 256
        return min(M, -(-cap // 512) * 512)

    # -- program B ------------------------------------------------------
    def _assemble(self, payload, m_pos, x_miss, cap: int, M: int):
        """Assemble the feature matrix: cache-served rows + miss rows
        scattered into their compacted positions."""
        if self.staged_clique:
            x = payload                      # rows straight from program A
        else:
            cache_rows = self.t._cache.cache_rows
            slot = payload
            x = jnp.where(
                (slot >= 0)[:, None],
                cache_rows[jnp.clip(slot, 0, cache_rows.shape[0] - 1)], 0)
        mp = jax.lax.slice(m_pos, (0,), (cap,))
        return x.at[jnp.where(mp >= 0, mp, M)].set(
            x_miss.astype(x.dtype), mode="drop")

    def _make_train_core(self, cap: int):
        """Program B, shard_map'd over the mesh: assemble features +
        fwd/bwd + pmean grads + update."""
        t = self.t
        sampler, model, tx = t.sampler_t, t.model_t, t.tx
        M = sampler.max_ids
        bs = t.config.sampler.batch_size
        n_steps = t.schedule.train_step

        def core(params, opt_state, ctr, base_key, batch, seeds, payload,
                 m_pos, x_miss, ybank):
            batch = jax.tree.map(lambda a: a[0], batch)
            seeds, payload = seeds[0], payload[0]
            m_pos, x_miss = m_pos[0], x_miss[0]
            x = self._assemble(payload, m_pos, x_miss, cap, M)
            k = t._device_key(base_key, ctr, 0)
            lid = ctr % n_steps
            y = jax.lax.dynamic_slice(ybank[0], (lid * bs,), (bs,))
            valid = seeds >= 0

            if t.is_lp:
                def loss_fn(p):
                    return model.loss(p, x, batch, valid, train=True,
                                      rng=jax.random.fold_in(k, 7))
            else:
                def loss_fn(p):
                    logits = model.apply(p, x, batch, train=True,
                                         rng=jax.random.fold_in(k, 7))
                    return _masked_ce(logits, y, valid)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = jax.lax.pmean(grads, t.axes)
            loss = jax.lax.pmean(loss, t.axes)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, ctr + 1, loss

        DP = t._DP
        sm = self._shard_map(
            core, t.mesh,
            in_specs=(P(), P(), P(), P(), DP, DP, DP, DP, DP, t._DPN),
            out_specs=(P(), P(), P(), P()))
        return jax.jit(sm, donate_argnums=(0, 1))

    def _make_eval(self, mode: Mode, ctr_name: str):
        t = self.t
        sampler, model = t.sampler_e, t.model_e
        bs = t.config.sampler.eval_batch_size
        M = sampler.max_ids
        cap = self.eval_miss_cap
        sample = self._sample_eval if mode == Mode.VALID \
            else self._sample_eval_test
        n_steps = max(t.schedule.valid_step, 1) if mode == Mode.VALID \
            else max(t.schedule.test_step, 1)

        def core(params, correct, total, ctr, batch, seeds, payload, m_pos,
                 x_miss, ybank):
            batch = jax.tree.map(lambda a: a[0], batch)
            seeds, payload = seeds[0], payload[0]
            m_pos, x_miss = m_pos[0], x_miss[0]
            x = self._assemble(payload, m_pos, x_miss, cap, M)
            lid = ctr % n_steps
            y = jax.lax.dynamic_slice(ybank[0], (lid * bs,), (bs,))
            valid = seeds >= 0
            if t.is_lp:
                loss = model.loss(params, x, batch, valid, train=False)
                tt = jnp.sum(valid[: bs // 3], dtype=jnp.int32)
                c = jax.lax.psum(loss * tt.astype(jnp.float32), t.axes)
                tt = jax.lax.psum(tt, t.axes).astype(jnp.float32)
                return correct + c, total + tt
            logits = model.apply(params, x, batch, train=False)
            pred = jnp.argmax(logits, axis=-1)
            c = jnp.sum((pred == y) & valid, dtype=jnp.int32)
            tt = jnp.sum(valid, dtype=jnp.int32)
            return correct + jax.lax.psum(c, t.axes), \
                total + jax.lax.psum(tt, t.axes)

        DP = t._DP
        core_sm = self._shard_map(
            core, t.mesh,
            in_specs=(P(), P(), P(), P(), DP, DP, DP, DP, DP, t._DPN),
            out_specs=(P(), P()))
        core_j = jax.jit(core_sm, donate_argnums=(1, 2))

        def run(state: Dict, bank, ybank) -> Dict:
            (batch, pos_map, seeds, payload, m_ids, m_pos, n_miss,
             hits, edges, _, _) = sample(
                state["pos_map"], state[ctr_name], state["base_key"], bank,
                t.graph_access, self._lookup, t.member_rows,
                t.topo_pairs, t.topo_blocks)
            worst = int(np.asarray(n_miss).max())
            if worst > cap:
                self.eval_miss_overflows += 1
                if self.eval_miss_overflows == 1:
                    import warnings
                    warnings.warn(
                        f"eval miss buffer overflow: {worst} > cap "
                        f"{cap}; dropped misses get zero features "
                        "(counted in eval_miss_overflows)", stacklevel=2)
            x_miss = self._gather_miss_rows(m_ids, cap)
            correct, total = core_j(state["params"], state["correct"],
                                    state["total"], state[ctr_name], batch,
                                    seeds, payload, m_pos, x_miss, ybank)
            return dict(state, pos_map=pos_map, correct=correct,
                        total=total, **{ctr_name: state[ctr_name] + 1})

        return run

    # -- host gather + prefetch loop ------------------------------------
    def _gather_miss_rows(self, m_ids, cap: int) -> jax.Array:
        """Host half of the staged miss path: gather each device's
        compacted miss rows from host features (parallel C++) and ship
        them back sharded [n_dev, cap, F]. The reference streams these
        rows over zero-copy UVA inside its kernels
        (cache_impl.cuh:239-272)."""
        from legion_tpu import native
        t = self.t
        ids_np = np.asarray(m_ids)[:, :cap]          # [n_dev, cap]
        # bf16 transfer when the cache is bf16: halves the bytes crossing
        # host->device, which dominates the staged step on slow links
        rows = native.gather_rows(t._host_feats, ids_np.reshape(-1),
                                  dtype=t._feat_dtype)
        rows = rows.reshape(t.n_dev, cap, -1)
        return jax.device_put(
            rows, NamedSharding(t.mesh, P(t.axes, None, None)))

    def _gather_train_miss(self, m_ids, n_miss) -> jax.Array:
        """Worker-thread half of the pipeline: block on the sample
        program's miss ids, gather their rows, ship to HBM (overlaps with
        device compute — the INTERBATCH_CON=2 pipeline)."""
        # overflow check rides the sync we already pay for the ids
        # (round-2 advisor: dropped tail misses were silent)
        worst = int(np.asarray(n_miss).max())
        if worst > self.miss_cap:
            self.miss_overflows += 1
            if self.miss_overflows == 1:
                import warnings
                warnings.warn(
                    f"staged miss buffer overflow: {worst} misses > "
                    f"cap {self.miss_cap}; overflowing rows feed zero "
                    "features this step (counted in miss_overflows)",
                    stacklevel=2)
        return self._gather_miss_rows(m_ids, self.miss_cap)

    def _dispatch_sample(self, pm, ctr: int, base_key):
        t = self.t
        out = self._sample_train(pm, jnp.int32(ctr), base_key,
                                 t.train_bank, t.graph_access,
                                 self._lookup, t.member_rows,
                                 t.topo_pairs, t.topo_blocks)
        # pm was donated into the sample; the chain head is its output
        self._pm = out[1]
        fut = self._gather_pool.submit(self._gather_train_miss, out[4],
                                       out[6])
        return ctr, out, fut

    def train_step(self, state: Dict) -> Tuple[Dict, jax.Array]:
        # VALUE-based resync (round-3 review): a state dict whose ctr value
        # disagrees with the host mirror — restored checkpoint, replayed
        # older state, reconstructed arrays — resyncs and drops any stale
        # lookahead (its pos_map chain stays valid — cleared maps are
        # content-equivalent). The int() sync is cheap here: the staged
        # path already blocks on the host gather every step.
        t = self.t
        if int(state["train_ctr"]) != self._ctr:
            self._ctr = int(state["train_ctr"])
            if self._prefetch is not None and \
                    self._prefetch[0] != self._ctr:
                self._prefetch = None
        ctr_host = self._ctr
        if self._prefetch is None:
            self._prefetch = self._dispatch_sample(
                self._pm, ctr_host, state["base_key"])
        _, out, fut = self._prefetch
        (batch, pm, seeds, slot, m_ids, m_pos, n_miss, hits, edges,
         topo_hits, topo_total) = out
        # dispatch step N+1's sample before blocking on step N's gather:
        # the device executes A_{N+1} while the host feeds B_N
        self._prefetch = self._dispatch_sample(
            pm, ctr_host + 1, state["base_key"])
        x_miss = fut.result()
        params, opt_state, ctr, loss = self._train_core(
            state["params"], state["opt_state"], state["train_ctr"],
            state["base_key"], batch, seeds, slot, m_pos, x_miss,
            t.train_ybank)
        self._ctr = ctr_host + 1
        t.last_feat_hits = hits
        t.last_edges = edges
        t.last_slots = hits + jnp.sum(n_miss)
        t.last_topo_hits = topo_hits
        t.last_topo_total = topo_total
        return dict(state, params=params, opt_state=opt_state,
                    train_ctr=ctr), loss

    def close(self) -> None:
        """Cancel the pending prefetch and stop the gather worker. Safe
        to call multiple times."""
        pf = self._prefetch
        if pf is not None:
            pf[2].cancel()
            self._prefetch = None
        pool = self._gather_pool
        if pool is not None:
            pool.shutdown(wait=False)
