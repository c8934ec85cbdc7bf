"""Unified cache: hot feature rows + hot topology sub-CSR in HBM.

Reference parity: UnifiedCache::FillUp (cache.cu:553-611) + the lookup paths
FindFeat/FindTopo (cache.cu:180-244). Design divergence (SURVEY.md §7): the
reference needs bucketed-cuckoo hash maps (vendored BGHT) because GPU HBM is
too precious for |V|-sized tables; below 200M vertices we spend 4
bytes/vertex on direct int32 slot tables (slot_map / row_map) — one gather
instead of a cuckoo probe chain, the single hottest lookup in the system.

Feature cache:  cache_rows [C_f, F] = features[QF[:C_f]];
                slot_map[v] = slot or -1            (FeatFillUp parity)
Topology cache: sub-CSR of the C_t hottest-expanded vertices;
                row_map[v] = cached row or -1       (GraphCache parity,
                graph_storage.cu:76-111)

Miss paths go to host storage (the pinned-UVA analog): batched host gathers
via `jax.pure_callback` — see CachedFeatureSource / CachedGraphAccess.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion_tpu.cache.cost_model import CostModelResult
from legion_tpu.graph import DeviceCSR


@partial(jax.jit, static_argnums=(2,))
def _build_feature_cache(features: jax.Array, qf: jax.Array, cap: int):
    hot = qf[:cap]
    cache_rows = features[hot]
    V = features.shape[0]
    slot_map = jnp.full((V,), -1, jnp.int32)
    slot_map = slot_map.at[hot].set(jnp.arange(cap, dtype=jnp.int32))
    return cache_rows, slot_map


@partial(jax.jit, static_argnums=(3, 4))
def _build_topo_cache(csr_indptr: jax.Array, csr_indices: jax.Array,
                      qt: jax.Array, cap: int, edge_budget: int):
    """Materialize the hot sub-CSR (degree count -> scan -> gather), the
    analog of TopoFillUp (graph_storage_impl.cuh:27-53)."""
    V = csr_indptr.shape[0] - 1
    hot = qt[:cap]
    deg = (csr_indptr[hot + 1] - csr_indptr[hot]).astype(jnp.int64)
    offs = jnp.cumsum(deg)
    total = offs[-1] if cap > 0 else jnp.int64(0)
    starts = offs - deg
    # truncate rows beyond the edge budget (static bound keeps shapes fixed)
    sub_indptr = jnp.concatenate([jnp.zeros((1,), jnp.int64), offs])
    sub_indptr = jnp.minimum(sub_indptr, edge_budget).astype(jnp.int64)
    # edge slot j belongs to cached row r(j) = searchsorted(offs, j, 'right')
    j = jnp.arange(edge_budget, dtype=jnp.int64)
    row = jnp.searchsorted(offs, j, side="right")
    row_c = jnp.clip(row, 0, jnp.maximum(cap - 1, 0))
    src_pos = csr_indptr[hot[row_c]].astype(jnp.int64) + (
        j - starts[row_c])
    valid = j < total
    sub_indices = jnp.where(
        valid, csr_indices[jnp.clip(src_pos, 0, csr_indices.shape[0] - 1)],
        -1).astype(jnp.int32)
    row_map = jnp.full((V,), -1, jnp.int32)
    row_map = row_map.at[hot].set(jnp.arange(cap, dtype=jnp.int32))
    return sub_indptr, sub_indices, row_map


@jax.tree_util.register_pytree_node_class
@dataclass
class UnifiedCache:
    """Device-resident unified cache (single cache group member)."""

    cache_rows: Optional[jax.Array]     # [C_f, F] float32
    slot_map: Optional[jax.Array]       # [V] int32, -1 = miss
    sub_indptr: Optional[jax.Array]     # [C_t+1] int64
    sub_indices: Optional[jax.Array]    # [E_c] int32
    row_map: Optional[jax.Array]        # [V] int32, -1 = miss
    feature_capacity: int
    topo_capacity: int

    def tree_flatten(self):
        return ((self.cache_rows, self.slot_map, self.sub_indptr,
                 self.sub_indices, self.row_map),
                (self.feature_capacity, self.topo_capacity))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, feature_capacity=aux[0], topo_capacity=aux[1])

    @classmethod
    def build(cls, plan: CostModelResult, features: jax.Array,
              csr: DeviceCSR) -> "UnifiedCache":
        cache_rows = slot_map = None
        sub_indptr = sub_indices = row_map = None
        if plan.feature_capacity > 0:
            cache_rows, slot_map = _build_feature_cache(
                features, plan.feature_order, plan.feature_capacity)
        if plan.topo_capacity > 0:
            degrees = np.asarray(csr.degrees()[
                plan.topo_order[:plan.topo_capacity]])
            edge_budget = int(degrees.sum())
            sub_indptr, sub_indices, row_map = _build_topo_cache(
                csr.indptr.astype(jnp.int64), csr.indices,
                plan.topo_order, plan.topo_capacity, max(edge_budget, 1))
        return cls(cache_rows=cache_rows, slot_map=slot_map,
                   sub_indptr=sub_indptr, sub_indices=sub_indices,
                   row_map=row_map,
                   feature_capacity=plan.feature_capacity,
                   topo_capacity=plan.topo_capacity)

    @classmethod
    def build_from_host(cls, plan: CostModelResult,
                        host_features: Optional[np.ndarray],
                        host_indptr: Optional[np.ndarray],
                        host_indices: Optional[np.ndarray],
                        num_nodes: int,
                        feat_dtype: str = "float32") -> "UnifiedCache":
        """FillUp from host-resident storage: hot feature rows and the hot
        sub-CSR are gathered on host (native runtime) and shipped to HBM
        once — the analog of FeatFillUp/TopoFillUp's H2D copies
        (cache_impl.cuh:183-188, graph_storage_impl.cuh:27-53).
        feat_dtype="bfloat16" stores the cache in bf16 (2x rows per byte
        budget; pair with plan_cache(bytes_per_feat=2))."""
        from legion_tpu import native
        cache_rows = slot_map = None
        sub_indptr = sub_indices = row_map = None
        V = num_nodes
        if plan.feature_capacity > 0 and host_features is not None:
            qf = np.asarray(plan.feature_order[:plan.feature_capacity],
                            np.int32)
            rows = native.gather_rows(
                np.ascontiguousarray(host_features, np.float32), qf,
                dtype=feat_dtype)
            cache_rows = jax.device_put(rows)
            slot_map = jnp.full((V,), -1, jnp.int32).at[
                jnp.asarray(qf)].set(
                jnp.arange(plan.feature_capacity, dtype=jnp.int32))
        if plan.topo_capacity > 0 and host_indptr is not None:
            qt = np.asarray(plan.topo_order[:plan.topo_capacity], np.int64)
            deg = host_indptr[qt + 1] - host_indptr[qt]
            offs = np.cumsum(deg)
            starts = offs - deg
            total = int(offs[-1]) if len(offs) else 0
            j = np.arange(total, dtype=np.int64)
            row = np.searchsorted(offs, j, side="right")
            src_pos = host_indptr[qt[row]] + (j - starts[row])
            sub_idx = np.asarray(host_indices)[src_pos].astype(np.int32)
            sub_ip = np.concatenate([[0], offs]).astype(np.int64)
            sub_indptr = jax.device_put(sub_ip)
            sub_indices = jax.device_put(sub_idx)
            row_map = jnp.full((V,), -1, jnp.int32).at[
                jnp.asarray(qt)].set(
                jnp.arange(plan.topo_capacity, dtype=jnp.int32))
        return cls(cache_rows=cache_rows, slot_map=slot_map,
                   sub_indptr=sub_indptr, sub_indices=sub_indices,
                   row_map=row_map,
                   feature_capacity=plan.feature_capacity,
                   topo_capacity=plan.topo_capacity)

    # ---- feature path ------------------------------------------------
    def find_feat(self, ids: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """ids -> (slot, hit); pad/-1 ids miss. (FindFeat, cache.cu:180)"""
        V = self.slot_map.shape[0]
        safe = jnp.clip(ids, 0, V - 1)
        slot = jnp.where(ids >= 0, self.slot_map[safe], -1)
        return slot, slot >= 0

    def gather_cached(self, slot: jax.Array) -> jax.Array:
        c = jnp.clip(slot, 0, self.cache_rows.shape[0] - 1)
        return self.cache_rows[c]


class FeatureSource:
    """Where feature rows come from in the train step."""

    def fetch(self, ids: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """ids [N] -> (rows [N, F], hits scalar int32)."""
        raise NotImplementedError


class _HostRef:
    """Identity-hashed holder for host numpy arrays in pytree aux data."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array

    def __hash__(self):
        return id(self.array)

    def __eq__(self, other):
        return isinstance(other, _HostRef) and other.array is self.array


@jax.tree_util.register_pytree_node_class
class DeviceFeatureSource(FeatureSource):
    """All features in HBM (graphs that fit — reference in-memory mode)."""

    def __init__(self, features: jax.Array):
        self.features = features

    def tree_flatten(self):
        return (self.features,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def fetch(self, ids):
        rows = self.features[jnp.clip(ids, 0, self.features.shape[0] - 1)]
        # zero pad rows (XLA fuses the select into the gather output):
        # every FeatureSource guarantees zeros for invalid ids, which lets
        # the aligned-hop aggregation contract over the fanout axis
        # UNMASKED (ops/hop_agg.py)
        rows = jnp.where((ids >= 0)[:, None], rows, 0)
        n = jnp.sum(ids >= 0, dtype=jnp.int32)
        return rows, n


@jax.tree_util.register_pytree_node_class
class CachedFeatureSource(FeatureSource):
    """HBM hot-row cache + host-memory fallback.

    The host fallback stands in for Legion's zero-copy UVA feature
    reads over PCIe (multiGPU_feat_cache_lookup's gidx<0 branch,
    cache_impl.cuh:239-272): misses become ONE batched host gather per step
    via pure_callback, overlapped by XLA with the cache-hit gather.
    """

    def __init__(self, cache: UnifiedCache, host_features: np.ndarray):
        self.cache = cache
        self.host = host_features  # np [V, F] float32 (mmap ok)
        self.feat_dim = host_features.shape[1]

    def tree_flatten(self):
        return (self.cache,), _HostRef(self.host)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux.array)

    def _host_gather(self, ids: np.ndarray) -> np.ndarray:
        from legion_tpu import native
        dt = "bfloat16" if self.cache.cache_rows.dtype == jnp.bfloat16 \
            else "float32"
        return native.gather_rows(self.host, np.asarray(ids, np.int32),
                                  dtype=dt)

    def fetch(self, ids):
        slot, hit = self.cache.find_feat(ids)
        miss_ids = jnp.where(hit, -1, ids)
        miss_rows = jax.pure_callback(
            self._host_gather,
            jax.ShapeDtypeStruct((ids.shape[0], self.feat_dim),
                                 self.cache.cache_rows.dtype),
            miss_ids, vmap_method="sequential")
        cached = self.cache.gather_cached(slot)
        rows = jnp.where(hit[:, None], cached, miss_rows)
        return rows, jnp.sum(hit, dtype=jnp.int32)
