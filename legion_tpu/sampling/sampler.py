"""Multi-hop fanout neighbor sampling with static shapes.

JAX rebuild of the reference sampling operators
(src/engine/operator_impl.cu):

  - ``batch_generate`` (:27-55)   -> seed registration into the position map
  - ``random_sample``  (:175-281) -> vectorized uniform neighbor draws +
                                     position-map dedup (two scatter passes
                                     replace the CUDA atomicOr bitmap +
                                     shared-memory staging)
  - ``construct_graph`` (:283-296)-> edge endpoint -> local index mapping
  - ``counter_update`` (:57-89)   -> per-hop cumulative node/edge counters
  - ``ClearPosMap``    (:542-548) -> scatter-clear of only the touched
                                     position-map entries
  - ``pre_sample``     (:301-397) -> hotness accumulation (segment adds
                                     replace atomicAdd counters)

Everything is compiled under one ``jit``: shapes are the reference's own
worst-case bounds (server.cu:188-199), pad id is -1 exactly like the CUDA
kernels (operator_impl.cu:40-43,232-234), and no data-dependent shapes
anywhere. Two dedup strategies ("map" scatters into a [V] position map —
Legion's own algorithm; "sort" is a pure sort/scan pipeline with no O(V)
state), plus a lane-aligned no-dedup mode for the last hop
(config.dedup_last_hop) that deletes the largest dedup and the first
aggregation layer's row gather outright.

Semantics preserved from the reference (deliberately):
  - sampling with replacement, uniform over each frontier node's neighbors;
  - *global* dedup: a node seen at any earlier hop is not re-expanded
    (frontier of hop k+1 = only the nodes newly discovered at hop k);
  - edges are stored reversed (src = sampled neighbor, dst = frontier node)
    so aggregation flows neighbor -> center (operator_impl.cu:256-257);
  - seeds occupy local positions [0, batch).

Improved over the reference: the per-slot ``thrust::minstd_rand
engine.discard(idx)`` stream (operator_impl.cu:235-238) repeats the identical
sample every epoch; we fold (epoch, step, hop) into a threefry key instead
(SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from legion_tpu.config import SamplerConfig
from legion_tpu.graph import DeviceCSR

INT32_MAX = jnp.iinfo(jnp.int32).max
# position-map claim tags live above any valid local index (max_ids < 2**30)
_CLAIM_BASE = jnp.int32(1 << 30)


@jax.tree_util.register_pytree_node_class
@dataclass
class SampleBatch:
    """One sampled mini-batch (static shapes, -1 padded).

    The trainer-visible contract mirrors the reference's IPC buffers + the
    16-slot counter protocol (ipc_service.cu:28-31, operator_impl.cu:57-89):
    ``node_ids`` = sampled_ids, ``edge_src/dst`` = agg_src/dst local offsets,
    ``num_nodes[1+k]`` = node_counter[9+k], ``num_edges[k]`` = cumulative
    edge_counter[9+k] (per-hop, not cumulative, here).
    """

    node_ids: jax.Array            # [N_max] int32 global ids, -1 pad
    num_nodes: jax.Array           # [L+1] int32, cumulative unique per hop
    edge_src: Tuple[jax.Array, ...]  # per hop [E_k] int32 local idx, -1 pad
    edge_dst: Tuple[jax.Array, ...]  # per hop [E_k] int32 local idx, -1 pad
    num_edges: jax.Array           # [L] int32 valid edges per hop
    # hop_offsets[k] = first local index of hop k's frontier. Hop-k edges
    # are FANOUT-MAJOR: lane f*F_k + i is draw f of frontier slot i, so
    # dst == hop_offsets[k] + lane % F_k — models exploit this to
    # aggregate with contiguous [fanout, F, d] slice reductions instead
    # of scatters (the structural consequence of the reference's frontier
    # rule, laid out fanout-major).
    hop_offsets: jax.Array         # [L] int32

    def tree_flatten(self):
        return ((self.node_ids, self.num_nodes, self.edge_src, self.edge_dst,
                 self.num_edges, self.hop_offsets), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_hops(self) -> int:
        return len(self.edge_src)


def _gather(arr: jax.Array, idx: jax.Array, valid: jax.Array,
            fill) -> jax.Array:
    """Gather with -1-safe indices: invalid lanes produce ``fill``."""
    safe = jnp.clip(idx, 0, arr.shape[0] - 1)
    out = arr[safe]
    return jnp.where(valid, out, fill)


class NeighborSampler:
    """Fanout sampler over a device-resident CSR.

    State is a single int32 position map of size [V] (the reference's
    ``position_map``, server.cu:228), functionally threaded through
    ``sample`` and scatter-cleared at the end of each batch, so steady-state
    cost is O(touched), not O(V).
    """

    def __init__(self, config: SamplerConfig, num_nodes: int):
        self.config = config
        self.num_nodes = num_nodes
        self.frontier_sizes = config.frontier_sizes()
        self.edge_sizes = config.edge_counts()
        self.cum_caps = config.cum_sizes()
        self.max_ids = config.max_ids
        self.capped = config.node_caps is not None
        self.aligned_last = not config.dedup_last_hop
        # with measured caps the ids buffer needs slack so frontier slices
        # never clamp back into filled territory
        slack = max(self.frontier_sizes[1:], default=0) if self.capped \
            else 0
        self.ids_len = self.max_ids + slack
        assert config.dedup in ("map", "sort"), config.dedup
        self.sort_dedup = config.dedup == "sort"
        if self.sort_dedup:
            # sort-dedup compacts each hop's new ids with one
            # dynamic_update_slice of static width W_k at dynamic offset
            # cum <= cum_caps[k]; the buffer must fit the window so DUS
            # never clamps back into filled territory
            L = config.num_hops
            for k in range(L):
                if self.aligned_last and k == L - 1:
                    continue
                W = min(self.edge_sizes[k], self.cum_caps[k + 1])
                self.ids_len = max(self.ids_len, self.cum_caps[k] + W)

    @property
    def state_size(self) -> int:
        """Length of the per-replica sampler state vector: the [V] position
        map for "map" dedup; a 1-element dummy for the stateless "sort"
        strategy."""
        return 1 if self.sort_dedup else self.num_nodes

    def init_state(self) -> jax.Array:
        """Fresh sampler state (position map for "map" dedup; dummy for
        "sort"); INT32_MAX = unseen."""
        return jnp.full((self.state_size,), INT32_MAX, dtype=jnp.int32)

    def sample_fn(self, csr: DeviceCSR, seeds: jax.Array, pos_map: jax.Array,
                  key: jax.Array) -> Tuple[SampleBatch, jax.Array]:
        """Un-jitted sampling body, for composition inside fused train
        steps / shard_map."""
        batch, pos_map, _, _ = self._sample_impl(csr, seeds, pos_map, key,
                                                 with_hotness=False)
        return batch, pos_map

    @partial(jax.jit, static_argnums=(0,), donate_argnums=(3,))
    def sample(self, csr: DeviceCSR, seeds: jax.Array, pos_map: jax.Array,
               key: jax.Array) -> Tuple[SampleBatch, jax.Array]:
        return self.sample_fn(csr, seeds, pos_map, key)

    def presample_fn(self, csr: DeviceCSR, seeds: jax.Array,
                     pos_map: jax.Array, key: jax.Array,
                     node_access: jax.Array, edge_access: jax.Array
                     ) -> Tuple[SampleBatch, jax.Array, jax.Array, jax.Array]:
        batch, pos_map, node_access, edge_access = self._sample_impl(
            csr, seeds, pos_map, key, with_hotness=True,
            node_access=node_access, edge_access=edge_access)
        return batch, pos_map, node_access, edge_access

    @partial(jax.jit, static_argnums=(0,), donate_argnums=(3, 5, 6))
    def presample(self, csr: DeviceCSR, seeds: jax.Array, pos_map: jax.Array,
                  key: jax.Array, node_access: jax.Array,
                  edge_access: jax.Array
                  ) -> Tuple[SampleBatch, jax.Array, jax.Array, jax.Array]:
        """Sampling pass that also accumulates hotness counters.

        node_access[v] += 1 per batch containing v (feature-fetch hotness,
        reference HotnessMeasure, cache.cu:40-68); edge_access[v] += 1 per
        frontier expansion of v (adjacency-read hotness, pre_sample
        operator_impl.cu:358).
        """
        return self.presample_fn(csr, seeds, pos_map, key, node_access,
                                 edge_access)

    def _dedup_map(self, cand, e_valid, cum, ids, pos_map, k, V):
        """Legion's dedup: claim/resolve scatter passes over the [V]
        position map (functional form of the atomicOr bitmap +
        position_map protocol, operator_impl.cu:244-279)."""
        E_k = cand.shape[0]
        cur = _gather(pos_map, cand, e_valid, INT32_MAX)
        is_new = e_valid & (cur == INT32_MAX)
        lane = jnp.arange(E_k, dtype=jnp.int32)
        claim = _CLAIM_BASE + lane
        pos_map = pos_map.at[jnp.where(is_new, cand, V)].min(
            claim, mode="drop")
        won = is_new & (_gather(pos_map, cand, is_new, -1) == claim)
        rank = jnp.cumsum(won, dtype=jnp.int32) - 1
        local_new = cum + rank
        cap_k = self.cum_caps[k + 1]
        kept = won & (local_new < cap_k)
        n_new = jnp.sum(kept, dtype=jnp.int32)
        pos_map = pos_map.at[jnp.where(kept, cand, V)].set(
            local_new, mode="drop")
        ids = ids.at[jnp.where(kept, local_new, self.ids_len)].set(
            cand, mode="drop")
        if self.capped:
            # winners beyond the measured cap were dropped: clear their
            # claim tags so later hops (and the next batch) stay clean
            t2 = _gather(pos_map, cand, e_valid, -1)
            stale = e_valid & (t2 >= _CLAIM_BASE)
            pos_map = pos_map.at[jnp.where(stale, cand, V)].set(
                INT32_MAX, mode="drop")
        src_l = _gather(pos_map, cand, e_valid, INT32_MAX)
        src_l = jnp.where(src_l == INT32_MAX, -1, src_l)
        return src_l, n_new, ids, pos_map

    def _dedup_sort(self, cand, e_valid, cum, ids, k):
        """Sort-based dedup: NO O(V) state, NO big random gathers/scatters.

        The dedup is three sorts plus O(n) scans over
        M = assigned-prefix + cand, with no scatter into a [V] table
        (whether this beats the "map" variant's scatters on the GPU is not
        measured yet):

          1. stable sort (id, tag) with assigned entries tagged by their
             position and candidate lanes tagged lane+P: each run of an
             equal id leads with its authority — the existing entry if
             one exists, else the lowest candidate lane (the same winner
             the reference's atomic claim protocol picks,
             operator_impl.cu:244-251);
          2. assign new positions to candidate-led runs by cumsum rank,
             then broadcast each run head's position to its lanes with an
             associative-scan fill-forward (log-passes of elementwise ops
             — no segment scatter);
          3. route positions back to lane order and compact the new
             unique ids to the front with two more sorts; the compacted
             block lands in `ids` via one dynamic_update_slice.
        """
        E_k = cand.shape[0]
        cap_k = self.cum_caps[k + 1]
        P = self.cum_caps[k]          # static cap on already-assigned slots
        W = min(E_k, cap_k)           # static cap on new ids this hop
        M = P + E_k

        prefix = jax.lax.slice(ids, (0,), (P,))
        pkey = jnp.where(prefix >= 0, prefix, INT32_MAX)
        ckey = jnp.where(e_valid, cand, INT32_MAX)
        keys = jnp.concatenate([pkey, ckey])
        # tag < P => existing entry at position tag; tag >= P => lane tag-P
        tags = jnp.arange(M, dtype=jnp.int32)
        # 1. one stable sort; ties keep assigned-before-candidate and
        # lane order among candidates
        skey, stag = jax.lax.sort_key_val(keys, tags, is_stable=True)
        valid_s = skey != INT32_MAX
        prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), skey[:-1]])
        run_start = valid_s & (skey != prev)
        is_exist = stag < P

        # 2. new positions for candidate-led runs
        new_head = run_start & ~is_exist
        rank = jnp.cumsum(new_head, dtype=jnp.int32) - 1
        pos_new = cum + rank
        kept_head = new_head & (pos_new < cap_k)
        head_pos = jnp.where(is_exist, stag,
                             jnp.where(kept_head, pos_new, -1))
        # fill-forward the run head's position across the run
        def _ff(a, b):
            return (a[0] | b[0], jnp.where(b[0], b[1], a[1]))
        _, src_pos = jax.lax.associative_scan(
            _ff, (run_start, jnp.where(run_start, head_pos, 0)))
        src_pos = jnp.where(valid_s, src_pos, -1)

        # 3a. route positions back to lanes: every candidate row (valid or
        # pad) has a distinct lane key, so the first E_k sorted entries are
        # exactly lanes 0..E_k-1
        lane_key = jnp.where(is_exist, INT32_MAX, stag - P)
        _, src_l_full = jax.lax.sort_key_val(lane_key, src_pos)
        src_l = jax.lax.slice(src_l_full, (0,), (E_k,))

        # 3b. compact new unique ids to the front in position order; the
        # masked (-1) tail of the window pads slots that stay empty
        n_new = jnp.sum(kept_head, dtype=jnp.int32)
        comp_key = jnp.where(kept_head, pos_new, INT32_MAX)
        comp_val = jnp.where(kept_head, skey, -1)
        _, comp = jax.lax.sort_key_val(comp_key, comp_val)
        new_block = jax.lax.slice(comp, (0,), (W,))
        ids = jax.lax.dynamic_update_slice(ids, new_block, (cum,))
        return src_l, n_new, ids

    # -- per-hop carry pieces: the staged trainer splits sampling into one
    # device program per hop (host neighbor draws between programs when
    # topology is host-resident, the reference's UVA branch
    # operator_impl.cu:224-243); the fused path composes the same pieces
    # in one program, so both paths share one hop-body implementation. --

    def begin(self, seeds: jax.Array, pos_map: jax.Array) -> dict:
        """Register seeds and build the hop-loop carry (batch_generate,
        operator_impl.cu:27-55)."""
        cfg = self.config
        V = self.num_nodes
        batch_size = cfg.batch_size
        assert seeds.shape == (batch_size,), (seeds.shape, batch_size)
        seeds = seeds.astype(jnp.int32)
        ids = jnp.full((self.ids_len,), -1, dtype=jnp.int32)
        ids = ids.at[:batch_size].set(seeds)
        seed_valid = seeds >= 0
        n_seeds = jnp.sum(seed_valid, dtype=jnp.int32)
        # sort-dedup needs no seed state — the ids prefix itself is the
        # membership structure
        if not self.sort_dedup:
            seed_scatter = jnp.where(seed_valid, seeds, V)
            pos_map = pos_map.at[seed_scatter].set(
                jnp.arange(batch_size, dtype=jnp.int32), mode="drop")
        return dict(ids=ids, pos_map=pos_map, cum=n_seeds,
                    frontier_off=jnp.int32(0), num_nodes=(n_seeds,),
                    num_edges=(), edge_src=(), edge_dst=(),
                    hop_offsets=())

    def hop_frontier(self, carry: dict, k: int) -> jax.Array:
        return jax.lax.dynamic_slice(
            carry["ids"], (carry["frontier_off"],),
            (self.frontier_sizes[k],))

    def hop_absorb(self, carry: dict, k: int, cand: jax.Array) -> dict:
        """Dedup hop k's candidate draws and record its edge lists
        (random_sample dedup + construct_graph + counter_update)."""
        V = self.num_nodes
        F_k = self.frontier_sizes[k]
        E_k = self.edge_sizes[k]
        L = self.config.num_hops
        ids, pos_map = carry["ids"], carry["pos_map"]
        cum, frontier_off = carry["cum"], carry["frontier_off"]
        e_valid = cand >= 0

        if self.aligned_last and k == L - 1:
            # lane-aligned last hop: no dedup, position = P_last + lane
            # (see SamplerConfig.dedup_last_hop for the cost argument).
            # num_nodes[-1] counts VALID slots; the filled region is
            # the static window [P_last, P_last + E_k).
            P_last = self.cum_caps[k]
            ids = jax.lax.dynamic_update_slice(ids, cand, (P_last,))
            src_l = jnp.where(
                e_valid, P_last + jnp.arange(E_k, dtype=jnp.int32), -1)
            n_new = jnp.sum(e_valid, dtype=jnp.int32)
        elif self.sort_dedup:
            src_l, n_new, ids = self._dedup_sort(
                cand, e_valid, cum, ids, k)
        else:
            src_l, n_new, ids, pos_map = self._dedup_map(
                cand, e_valid, cum, ids, pos_map, k, V)

        # --- construct_graph: local indices. dst falls out of the
        # structured FANOUT-MAJOR layout: lane f*F_k + i is draw f of
        # frontier row i at position frontier_off + i ---
        e_ok = src_l >= 0
        lane = jnp.arange(E_k, dtype=jnp.int32)
        dst_l = jnp.where(e_ok, frontier_off + lane % F_k, -1)
        return dict(
            ids=ids, pos_map=pos_map, cum=cum + n_new, frontier_off=cum,
            num_nodes=carry["num_nodes"] + (cum + n_new,),
            num_edges=carry["num_edges"]
            + (jnp.sum(e_ok, dtype=jnp.int32),),
            edge_src=carry["edge_src"] + (src_l,),
            edge_dst=carry["edge_dst"] + (dst_l,),
            hop_offsets=carry["hop_offsets"] + (frontier_off,))

    def finish(self, carry: dict) -> Tuple[SampleBatch, jax.Array]:
        """ClearPosMap + assemble the SampleBatch."""
        L = self.config.num_hops
        ids, pos_map = carry["ids"], carry["pos_map"]
        if not self.sort_dedup:
            # ClearPosMap: reset only touched entries (an aligned last hop
            # never touches the position map, so skip its lanes)
            touched = ids if not self.aligned_last else \
                jax.lax.slice(ids, (0,), (self.cum_caps[L - 1],))
            pos_map = pos_map.at[jnp.where(touched >= 0, touched,
                                           self.num_nodes)].set(
                INT32_MAX, mode="drop")
        batch = SampleBatch(
            node_ids=ids,
            num_nodes=jnp.stack(carry["num_nodes"]),
            edge_src=carry["edge_src"],
            edge_dst=carry["edge_dst"],
            num_edges=jnp.stack(carry["num_edges"]),
            hop_offsets=jnp.stack(carry["hop_offsets"]),
        )
        return batch, pos_map

    def _sample_impl(self, csr: DeviceCSR, seeds: jax.Array,
                     pos_map: jax.Array, key: jax.Array, with_hotness: bool,
                     node_access: Optional[jax.Array] = None,
                     edge_access: Optional[jax.Array] = None):
        from legion_tpu.sampling.access import DeviceCSRAccess, GraphAccess
        if isinstance(csr, DeviceCSR):
            access: GraphAccess = DeviceCSRAccess(csr)
        else:
            access = csr

        V = self.num_nodes
        L = self.config.num_hops
        carry = self.begin(seeds, pos_map)
        for k in range(L):
            frontier = self.hop_frontier(carry, k)
            if with_hotness:
                # adjacency-read hotness for expanded frontier nodes
                edge_access = edge_access.at[
                    jnp.where(frontier >= 0, frontier, V)].add(
                    1, mode="drop")
            hop_key = jax.random.fold_in(key, k)
            cand = access.sample_neighbors(frontier, self.config.fanouts[k],
                                           hop_key)
            # cand: [E_k] global ids, -1 where frontier pad / deg 0
            carry = self.hop_absorb(carry, k, cand)

        if with_hotness:
            node_access = node_access.at[
                jnp.where(carry["ids"] >= 0, carry["ids"], V)].add(
                1, mode="drop")
        batch, pos_map = self.finish(carry)
        return batch, pos_map, node_access, edge_access
