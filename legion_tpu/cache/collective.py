"""Clique-aggregated caches: interleaved shards + NVLink peer reads.

Reference parity: Legion's central contribution is aggregating the cache
capacity of an NVLink clique — GPU j of a Kg-clique caches the i-th hottest
vertex iff i % Kg == j, at local row i // Kg, and lookups read peer caches
directly over NVLink. Features: cache_impl.cuh:104-109 +
multiGPU_feat_cache_lookup (cache_impl.cuh:239-272). Topology: the hot
sub-CSR partitioned the same way (cache_impl.cuh:89-101) with per-device
sub-CSR materialization (graph_storage.cu:76-111) and peer reads inside the
sampling kernel (operator_impl.cu:224-243).

JAX translation: the clique is the mesh's "member" axis. Each member holds a
shard (feature rows [R, F] / sub-CSR rows); the hotness-interleaved layout
makes request load uniform across members, so per-owner request lists are
boundable at ~1.5x N/Kg. A lookup becomes:

  sort ids by owning member -> fixed-size per-owner request matrices ->
  all_to_all (requests ride NVLink) -> local row gathers / neighbor draws ->
  all_to_all back -> unsort.  Overflowing or uncached ids fall back to the
  host store — via pure_callback inside the program
  (host_transfer="callback") or via the trainer's staged miss pipeline
  (host_transfer="staged", train.py).

Use inside shard_map over the ("clique", "member") mesh; `member_rows` /
`member_topo` is the caller's per-member shard of the sharded cache array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def build_clique_cache(feature_order: np.ndarray, group_capacity: int,
                       host_features: np.ndarray, group_size: int,
                       feat_dtype: str = "float32",
                       map_impl: str = "direct"):
    """Host-side FillUp (cache.cu:553-611).

    Returns (slot_map, member_rows [Kg, R, F] in feat_dtype, R) where
    slot_map maps id -> GLOBAL slot (-1 absent): a [V] int32 numpy table
    (map_impl="direct") or a HashMap32 (~32B per CACHED vertex
    regardless of V — billion-vertex safe; the BGHT role,
    cache.cu:71-88).
    Global slot i (i-th hottest cached vertex) lives on member i % Kg at
    local row i // Kg. feat_dtype="bfloat16" halves shard bytes (2x rows
    per budget; pair with plan_cache(bytes_per_feat=2)).
    """
    from legion_tpu import native
    V, F = host_features.shape
    Kg = group_size
    C = (group_capacity // Kg) * Kg  # whole rows per member
    R = max(C // Kg, 1)
    hot = np.asarray(feature_order[:C], np.int32)
    if map_impl == "hash":
        from legion_tpu.cache.hashmap import HashMap32
        slot_map = HashMap32.build(hot, np.arange(C, dtype=np.int32))
    else:
        slot_map = np.full(V, -1, np.int32)
        slot_map[hot] = np.arange(C, dtype=np.int32)
    if feat_dtype == "bfloat16":
        import ml_dtypes
        npdt = ml_dtypes.bfloat16
    else:
        npdt = np.float32
    member_rows = np.zeros((Kg, R, F), npdt)
    for j in range(Kg):
        ids_j = hot[j::Kg]
        member_rows[j, : len(ids_j)] = native.gather_rows(
            host_features, ids_j, dtype=feat_dtype)
    return slot_map, member_rows, R


def _bucket_by_owner(owner: jax.Array, payload: jax.Array, Kg: int,
                     R_req: int):
    """Sort N requests by owning member and pack them into fixed-size
    per-owner matrices.

    owner: [N] int32 in [0, Kg) for routable entries, >= Kg for misses.
    payload: [N] int32 row to request from the owner.
    Returns (req [Kg, R_req] payloads (-1 pad), in_bounds [N] bool in
    original order, so_c [N] clipped sorted owners, pos [N] position within
    the owner segment, perm [N], inv [N] inverse permutation).
    """
    N = owner.shape[0]
    perm = jnp.argsort(owner, stable=True)
    sorted_owner = owner[perm]
    sorted_payload = payload[perm]
    seg_start = jnp.searchsorted(sorted_owner,
                                 jnp.arange(Kg + 1, dtype=owner.dtype))
    so_c = jnp.clip(sorted_owner, 0, Kg - 1)
    pos = jnp.arange(N, dtype=jnp.int32) - seg_start[so_c].astype(jnp.int32)
    in_bounds_s = (sorted_owner < Kg) & (pos < R_req)

    req = jnp.full((Kg * R_req,), -1, jnp.int32)
    flat_idx = jnp.where(in_bounds_s, so_c * R_req + pos, Kg * R_req)
    req = req.at[flat_idx].set(sorted_payload, mode="drop").reshape(
        Kg, R_req)
    inv = jnp.zeros((N,), jnp.int32).at[perm].set(
        jnp.arange(N, dtype=jnp.int32))
    in_bounds = jnp.zeros((N,), bool).at[perm].set(in_bounds_s)
    return req, in_bounds, so_c, pos, inv


def _exchange(x: jax.Array, axis: str) -> jax.Array:
    """all_to_all along the member axis: row o of x goes to member o."""
    out = jax.lax.all_to_all(x[:, None], axis, split_axis=0, concat_axis=0,
                             tiled=False)
    return out.reshape(x.shape)


class CliqueFeatureCache:
    """Collective feature fetch over the member axis (call in shard_map)."""

    def __init__(self, slot_map, host_features: np.ndarray,
                 group_size: int, capacity_per_member: int,
                 axis_name: str = "member", request_slack: float = 1.5):
        # id -> global slot: [V] int32 table or HashMap32 (both pytrees)
        self.slot_map = slot_map
        self.host = host_features         # np [V, F]
        self.Kg = group_size
        self.R = capacity_per_member
        self.axis = axis_name
        self.slack = request_slack
        self.feat_dim = host_features.shape[1]

    def tree_flatten(self):
        from legion_tpu.cache.unified_cache import _HostRef
        return ((self.slot_map,),
                (_HostRef(self.host), self.Kg, self.R, self.axis,
                 self.slack))

    @classmethod
    def tree_unflatten(cls, aux, children):
        host, Kg, R, axis, slack = aux
        return cls(children[0], host.array, Kg, R, axis, slack)

    def _host_gather(self, ids: np.ndarray, dt: str) -> np.ndarray:
        from legion_tpu import native
        return native.gather_rows(self.host, np.asarray(ids, np.int32),
                                  dtype=dt)

    def collective_bytes(self, n_ids: int, bytes_per_feat: int = 2
                         ) -> dict:
        """Per-device collective bytes for ONE fetch_cached(ids[n_ids]) call:
        the all_to_all request (int32 local rows) and response (feature
        rows) volumes, with the off-chip fraction (Kg-1)/Kg — the
        measured-bytes analog of the reference's PCM PCIe counters
        (monitor.cuh role) for the clique collective. Static per step, so
        accounting is exact without instrumentation."""
        R_req = int(-(-n_ids * self.slack // self.Kg))
        req = self.Kg * R_req * 4
        resp = self.Kg * R_req * self.feat_dim * bytes_per_feat
        off = (self.Kg - 1) / max(self.Kg, 1)
        return dict(request_bytes=req, response_bytes=resp,
                    offchip_bytes=int((req + resp) * off), R_req=R_req)

    def fetch_cached(self, ids: jax.Array, member_rows: jax.Array
                     ) -> Tuple[jax.Array, jax.Array]:
        """Collective-only lookup: ids [N] (-1 pad), member_rows [R, F]
        this member's shard. Returns (rows [N, F] with zeros on misses,
        collective_hit [N] bool). No host traffic — the caller owns the
        miss path (pure_callback in `fetch`, or the trainer's staged host
        gather)."""
        from legion_tpu.cache.hashmap import map_lookup
        N = ids.shape[0]
        Kg, R, F = self.Kg, self.R, self.feat_dim
        R_req = int(-(-N * self.slack // Kg))

        slot = map_lookup(self.slot_map, ids)
        hit = slot >= 0
        owner = jnp.where(hit, slot % Kg, Kg)          # misses -> bucket Kg
        local = jnp.where(hit, slot // Kg, 0)

        req, in_bounds, so_c, pos, inv = _bucket_by_owner(
            owner, local, Kg, R_req)
        req_recv = _exchange(req, self.axis)
        # serve from my shard
        served = jnp.where(
            (req_recv >= 0)[..., None],
            member_rows[jnp.clip(req_recv, 0, R - 1)], 0)
        rows_back = _exchange(served, self.axis)

        # unsort: my request at (owner o, pos p) sits at sorted index
        # seg_start[o] + p == its own sorted position; out-of-bounds lanes
        # read garbage here and are zeroed by the final hit mask
        out_sorted = rows_back[so_c, jnp.clip(pos, 0, R_req - 1)]
        rows = out_sorted[inv]
        collective_hit = hit & in_bounds
        rows = jnp.where(collective_hit[:, None], rows, 0)
        return rows, collective_hit

    def fetch(self, ids: jax.Array, member_rows: jax.Array
              ) -> Tuple[jax.Array, jax.Array]:
        """ids [N] int32 (-1 pad), member_rows [R, F] this member's shard.
        Returns (rows [N, F], hits int32). Misses + overflow fall back to
        the host store via ONE batched pure_callback gather — the UVA miss
        branch of multiGPU_feat_cache_lookup (cache_impl.cuh:239-272)."""
        rows, collective_hit = self.fetch_cached(ids, member_rows)
        N, F = ids.shape[0], self.feat_dim
        dt = "bfloat16" if member_rows.dtype == jnp.bfloat16 else "float32"
        miss_ids = jnp.where(collective_hit, -1, ids)
        miss_rows = jax.pure_callback(
            lambda i: self._host_gather(i, dt),
            jax.ShapeDtypeStruct((N, F), member_rows.dtype),
            miss_ids, vmap_method="sequential")
        rows = jnp.where(collective_hit[:, None], rows,
                         miss_rows.astype(rows.dtype))
        return rows, jnp.sum(collective_hit, dtype=jnp.int32)


jax.tree_util.register_pytree_node_class(CliqueFeatureCache)


# ---------------------------------------------------------------------------
# Clique topology cache
# ---------------------------------------------------------------------------

def build_clique_topo(topo_order: np.ndarray, group_capacity: int,
                      host_indptr: np.ndarray, host_indices: np.ndarray,
                      group_size: int, window: int = 64,
                      map_impl: str = "direct"):
    """Host-side topology FillUp: partition the hot sub-CSR across the Kg
    clique members (cache_impl.cuh:89-101 + graph_storage.cu:76-111).

    Member j owns global topo slot i (the i-th hottest-expanded vertex)
    iff i % Kg == j, stored at local row i // Kg. Per-member shards are
    padded to a common edge budget so they stack into one sharded array.

    Returns (row_map: [V] int32 global slots or -1 (map_impl="direct"),
                 or a HashMap32 (~32B per cached vertex, billion-vertex
                 safe — "hash"),
             member_pairs [Kg, R, 2] (start, degree) in the member's local
                 edge space,
             member_indices2d [Kg, Eb//window, window] int32 (-1 pad),
             R).
    """
    V = host_indptr.shape[0] - 1
    Kg = group_size
    C = (group_capacity // Kg) * Kg
    R = max(C // Kg, 1)
    hot = np.asarray(topo_order[:C], np.int64)
    if map_impl == "hash":
        from legion_tpu.cache.hashmap import HashMap32
        row_map = HashMap32.build(hot, np.arange(C, dtype=np.int32))
    else:
        row_map = np.full(V, -1, np.int32)
        row_map[hot] = np.arange(C, dtype=np.int32)

    deg_all = (host_indptr[1:] - host_indptr[:-1]).astype(np.int64)
    # per-member edge budget = max over members, rounded to the window
    budgets = []
    for j in range(Kg):
        ids_j = hot[j::Kg]
        budgets.append(int(deg_all[ids_j].sum()) if len(ids_j) else 0)
    Eb = max(max(budgets), 1)
    Eb = -(-Eb // window) * window

    member_pairs = np.zeros((Kg, R, 2), np.int64)
    member_indices = np.full((Kg, Eb), -1, np.int32)
    for j in range(Kg):
        ids_j = hot[j::Kg]
        deg_j = deg_all[ids_j]
        offs = np.cumsum(deg_j)
        starts = offs - deg_j
        member_pairs[j, : len(ids_j), 0] = starts
        member_pairs[j, : len(ids_j), 1] = deg_j
        total = int(offs[-1]) if len(offs) else 0
        if total:
            # vectorized segment gather (same searchsorted trick as
            # UnifiedCache.build_from_host)
            e = np.arange(total, dtype=np.int64)
            row = np.searchsorted(offs, e, side="right")
            src = host_indptr[ids_j[row]] + (e - starts[row])
            member_indices[j, :total] = host_indices[src]
    if Eb < 2 ** 31:
        member_pairs = member_pairs.astype(np.int32)
    member_indices2d = member_indices.reshape(Kg, Eb // window, window)
    return row_map, member_pairs, member_indices2d, R


class CliqueTopoCache:
    """Collective neighbor draws from the clique-partitioned hot sub-CSR.

    GraphAccess-compatible: `sample_neighbors(frontier, fanout, key)` draws
    uniformly from each frontier vertex's cached row, with the row served
    by its owning member over NVLink (the reference reads peer sub-CSRs over
    NVLink inside random_sample, operator_impl.cu:224-243). The draw uses
    the same block-windowed scheme as WindowedCSRAccess: one aligned
    W-wide block read per served row, exact 1/deg per-draw marginals.

    Misses (uncached vertices or request overflow) are drawn by
    `fallback` — another GraphAccess (host callback draws on CPU/test
    runtimes; the staged trainer splits them out instead). Call inside
    shard_map with `member_pairs`/`member_indices2d` bound to THIS
    member's shard.
    """

    def __init__(self, row_map, member_pairs: jax.Array,
                 member_indices2d: jax.Array, fallback,
                 group_size: int, axis_name: str = "member",
                 request_slack: float = 1.5):
        # id -> global topo slot: [V] int32 table or HashMap32
        self.row_map = row_map
        self.member_pairs = member_pairs    # [R, 2] this member's rows
        self.member_indices2d = member_indices2d  # [Eb//W, W]
        self.fallback = fallback
        self.Kg = group_size
        self.axis = axis_name
        self.slack = request_slack
        self.num_nodes = getattr(fallback, "num_nodes",
                                 int(getattr(row_map, "shape",
                                             (2 ** 31 - 1,))[0]))

    def tree_flatten(self):
        return ((self.row_map, self.member_pairs, self.member_indices2d,
                 self.fallback), (self.Kg, self.axis, self.slack))

    @classmethod
    def tree_unflatten(cls, aux, children):
        rm, mp, mi, fb = children
        return cls(rm, mp, mi, fb, aux[0], aux[1], aux[2])

    def bind_shard(self, pairs: jax.Array, blocks: jax.Array
                   ) -> "CliqueTopoCache":
        """Bind THIS member's shard arrays (inside shard_map the sharded
        arrays arrive as separate args; the access template carries None)."""
        return CliqueTopoCache(self.row_map, pairs, blocks, self.fallback,
                               self.Kg, self.axis, self.slack)

    @property
    def window(self) -> int:
        return int(self.member_indices2d.shape[-1])

    def _draw_local(self, rows: jax.Array, fanout: int, key: jax.Array
                    ) -> jax.Array:
        """Draw fanout neighbors for each requested local row of MY shard
        (rows [Kg, R_req], -1 = no request). Returns [Kg, R_req, fanout]
        global neighbor ids (-1 invalid)."""
        Kg_, R_req = rows.shape
        W = self.window
        R = self.member_pairs.shape[0]
        # decorrelate owners when callers pass a clique-replicated key (the
        # trainer's per-device keys already differ; fold is harmless there)
        key = jax.random.fold_in(key, jax.lax.axis_index(self.axis))
        ok_row = rows >= 0
        pd = self.member_pairs[jnp.clip(rows, 0, R - 1)]
        start = jnp.where(ok_row, pd[..., 0], 0)
        deg = jnp.where(ok_row, pd[..., 1], 0)
        ok = deg > 0
        k0, k1 = jax.random.split(key)
        deg32 = jnp.minimum(deg, jnp.asarray(2 ** 31 - 1, deg.dtype)
                            ).astype(jnp.int32)
        r0 = jax.random.randint(k0, rows.shape, 0, jnp.maximum(deg32, 1),
                                dtype=jnp.int32)
        blk = (start + r0.astype(start.dtype)) // W
        base = blk * W
        lo = (jnp.maximum(base, start) - base).astype(jnp.int32)
        hi = (jnp.minimum(base + W, start + deg) - base).astype(jnp.int32)
        m = jnp.maximum(hi - lo, 1)
        off = lo[..., None] + jax.random.randint(
            k1, rows.shape + (fanout,), 0, m[..., None], dtype=jnp.int32)
        blocks = self.member_indices2d[
            jnp.clip(blk, 0, self.member_indices2d.shape[0] - 1)]
        sel = off[..., None] == jnp.arange(W, dtype=jnp.int32)
        cand = jnp.sum(jnp.where(sel, blocks[..., None, :], 0), axis=-1,
                       dtype=jnp.int32)
        return jnp.where(ok[..., None], cand, -1)

    def collective_bytes(self, n_frontier: int, fanout: int) -> dict:
        """Per-device collective bytes for ONE lookup(frontier[n_frontier]) call:
        all_to_all row requests (int32) and drawn-neighbor responses
        (int32 x fanout). See CliqueFeatureCache.collective_bytes."""
        R_req = int(-(-n_frontier * self.slack // self.Kg))
        req = self.Kg * R_req * 4
        resp = self.Kg * R_req * fanout * 4
        off = (self.Kg - 1) / max(self.Kg, 1)
        return dict(request_bytes=req, response_bytes=resp,
                    offchip_bytes=int((req + resp) * off), R_req=R_req)

    def lookup(self, frontier: jax.Array, fanout: int, key: jax.Array
               ) -> Tuple[jax.Array, jax.Array]:
        """Collective-only draws: returns (nbr [fanout*F] int32 in
        fanout-major lane order with -1 on miss lanes, served [F] bool)."""
        from legion_tpu.cache.hashmap import map_lookup
        F = frontier.shape[0]
        Kg = self.Kg
        R_req = int(-(-F * self.slack // Kg))

        slot = map_lookup(self.row_map, frontier)
        hit = slot >= 0
        owner = jnp.where(hit, (slot % Kg).astype(jnp.int32), Kg)
        local = jnp.where(hit, (slot // Kg).astype(jnp.int32), -1)

        req, in_bounds, so_c, pos, inv = _bucket_by_owner(
            owner, local, Kg, R_req)
        req_recv = _exchange(req, self.axis)
        drawn = self._draw_local(req_recv, fanout, key)   # [Kg, R_req, fo]
        drawn_back = _exchange(drawn, self.axis)

        out_sorted = drawn_back[so_c, jnp.clip(pos, 0, R_req - 1)]
        nbr = out_sorted[inv]                              # [F, fanout]
        served = hit & in_bounds
        nbr = jnp.where(served[:, None], nbr, -1)
        return nbr.T.reshape(-1), served

    def sample_neighbors(self, frontier: jax.Array, fanout: int,
                         key: jax.Array) -> jax.Array:
        nbr, served = self.lookup(frontier, fanout, key)
        miss_frontier = jnp.where(served, -1, frontier)
        nbr_miss = self.fallback.sample_neighbors(
            miss_frontier, fanout, jax.random.fold_in(key, 3))
        return jnp.where(jnp.tile(served, fanout), nbr, nbr_miss)

    # split-draw API (sampling.access.GraphAccess): host draws replicate
    # the fallback path's exact RNG consumption
    @property
    def needs_host_draws(self) -> bool:
        return getattr(self.fallback, "needs_host_draws", False)

    def host_seed(self, key: jax.Array) -> jax.Array:
        return self.fallback.host_seed(jax.random.fold_in(key, 3))

    def host_draw(self, frontier, fanout: int, seed):
        return self.fallback.host_draw(frontier, fanout, seed)

    @staticmethod
    def merge_draws(lanes, served, host_nbr, fanout: int):
        return jnp.where(jnp.tile(served, fanout), lanes,
                         host_nbr.T.reshape(-1))


jax.tree_util.register_pytree_node_class(CliqueTopoCache)


class HostFallbackAccess:
    """GraphAccess that draws every (non -1) frontier vertex's neighbors on
    the host via ONE batched pure_callback — the pinned-UVA full-CSR slot
    [partition_count] of the reference (operator_impl.cu:224-243) for
    runtimes with callback support. The staged trainer replaces this with
    its split-program pipeline."""

    def __init__(self, host_indptr: np.ndarray, host_indices: np.ndarray):
        self.host_indptr = host_indptr
        self.host_indices = host_indices
        self.num_nodes = int(host_indptr.shape[0]) - 1

    def tree_flatten(self):
        from legion_tpu.cache.unified_cache import _HostRef
        return ((), (_HostRef(self.host_indptr),
                     _HostRef(self.host_indices)))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0].array, aux[1].array)

    needs_host_draws = True

    def _host_draw(self, frontier: np.ndarray, fanout: int,
                   seed: np.ndarray) -> np.ndarray:
        from legion_tpu import native
        return native.sample_neighbors(
            self.host_indptr, self.host_indices,
            np.asarray(frontier, np.int32), int(fanout), int(seed))

    host_draw = _host_draw

    def host_seed(self, key):
        return jax.random.randint(jax.random.fold_in(key, 1), (), 0,
                                  jnp.iinfo(jnp.int32).max, jnp.int32)

    def lookup(self, frontier, fanout, key):
        """Nothing served on device: every valid slot is a host draw."""
        F = frontier.shape[0]
        return jnp.full((fanout * F,), -1, jnp.int32), \
            jnp.zeros((F,), bool)

    def sample_neighbors(self, frontier, fanout, key):
        F = frontier.shape[0]
        seed = self.host_seed(key)
        nbr = jax.pure_callback(
            lambda f, s: self._host_draw(f, fanout, s),
            jax.ShapeDtypeStruct((F, fanout), jnp.int32),
            frontier, seed, vmap_method="sequential")
        return nbr.T.reshape(-1)


jax.tree_util.register_pytree_node_class(HostFallbackAccess)
