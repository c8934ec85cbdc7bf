"""Bucketed open-addressing hash map for billion-vertex id->slot lookups.

The reference vendors BGHT bucketed-cuckoo hash tables (src/include/hashmap,
bcht.hpp) because GPU HBM cannot afford a direct [V] table per map at
billion-vertex scale (cache.cu:71-88). The default here is the direct
int32 table (one gather — fastest); this map is the billion-scale fallback:

  memory:  ~32 bytes per cached vertex (load factor 0.5, bucket 8)
           vs 4 bytes x |V| for the direct table — at uk2014 scale
           (0.79B vertices) a direct slot_map + row_map pair costs 6.3GB
           of HBM, the hash pair costs ~32B x cached rows regardless of V.
  lookup:  `probes` batched row gathers of [8]-wide buckets + compares —
           2-3x a direct gather, still fully vectorized (no probe chains
           of dependent scalar reads like cuckoo on CPU).

Build is host-side vectorized numpy (one pass per probe round).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

BUCKET = 8
_MULT = np.uint32(0x9E3779B1)          # Fibonacci hashing multiplier


def _hash(ids: np.ndarray, n_buckets: int) -> np.ndarray:
    h = (ids.astype(np.uint32) * _MULT)
    return (h % np.uint32(n_buckets)).astype(np.int64)


@jax.tree_util.register_pytree_node_class
@dataclass
class HashMap32:
    """Static int32->int32 map; -1 = absent. Query with `lookup`."""

    keys: jax.Array   # [B, BUCKET] int32, -1 = empty slot
    vals: jax.Array   # [B, BUCKET] int32
    probes: int       # max probe rounds needed at build time

    def tree_flatten(self):
        return (self.keys, self.vals), (self.probes,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def n_buckets(self) -> int:
        return int(self.keys.shape[0])

    @property
    def hbm_bytes(self) -> int:
        return 2 * self.n_buckets * BUCKET * 4

    @classmethod
    def build(cls, ids: np.ndarray, vals: np.ndarray,
              load: float = 0.5) -> "HashMap32":
        """ids: unique non-negative int32 keys; vals: int32 payloads."""
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.int32)
        n = len(ids)
        B = 1 << max(int(np.ceil(np.log2(max(n, 1) / (load * BUCKET)))), 1)
        keys_t = np.full((B, BUCKET), -1, np.int32)
        vals_t = np.zeros((B, BUCKET), np.int32)
        fill = np.zeros(B, np.int32)
        h0 = _hash(ids, B)
        pending = np.arange(n)
        rounds = 0
        while len(pending):
            assert rounds < 64, "hash table build degenerated; lower load"
            b = (h0[pending] + rounds) % B
            order = np.argsort(b, kind="stable")
            bs = b[order]
            ps = pending[order]
            # rank within each equal-bucket run
            first = np.searchsorted(bs, bs, side="left")
            rank = np.arange(len(bs)) - first
            free = BUCKET - fill[bs]
            place = rank < free
            slot = fill[bs] + rank
            keys_t[bs[place], slot[place]] = ids[ps[place]].astype(np.int32)
            vals_t[bs[place], slot[place]] = vals[ps[place]]
            placed_b, counts = np.unique(bs[place], return_counts=True)
            fill[placed_b] += counts.astype(np.int32)
            pending = ps[~place]
            rounds += 1
        return cls(jax.device_put(keys_t), jax.device_put(vals_t),
                   max(rounds, 1))

    def lookup(self, ids: jax.Array) -> jax.Array:
        """ids [N] int32 (-1 pad) -> vals [N] int32, -1 when absent."""
        B = self.n_buckets
        safe = jnp.maximum(ids, 0)
        h = (safe.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)) % \
            jnp.uint32(B)
        b0 = h.astype(jnp.int32)
        out = jnp.full(ids.shape, -1, jnp.int32)
        for p in range(self.probes):
            b = (b0 + p) % B
            krow = self.keys[b]                      # [N, BUCKET] row DMA
            vrow = self.vals[b]
            m = krow == ids[:, None]
            hit = jnp.any(m, axis=1)
            # dtype pinned: with jax_enable_x64 the default sum dtype
            # promotes to int64, breaking the int32 contract downstream
            # (int64 slots reaching int32 scatters in collective.py)
            val = jnp.sum(jnp.where(m, vrow, 0), axis=1, dtype=jnp.int32)
            out = jnp.where((out < 0) & hit, val, out)
        return jnp.where(ids >= 0, out, -1)

    # duck-type the direct-table API used by the staged sample program
    def __getitem__(self, ids: jax.Array) -> jax.Array:
        return self.lookup(ids)

    @property
    def shape(self) -> Tuple[int, ...]:
        # sentinel "table length" for clip-style callers: hash lookups
        # clip internally, so expose a huge virtual length
        return (2 ** 31 - 1,)


def map_lookup(m, ids: jax.Array) -> jax.Array:
    """id -> value through either map implementation: a direct [V] int32
    table (-1-pad-safe clip+mask gather) or a HashMap32. Lets the clique
    caches swap their replicated [V] tables for the ~32B/cached-vertex
    hash at billion-vertex scale (CacheConfig.map_impl; the BGHT role,
    reference cache.cu:71-88)."""
    if isinstance(m, HashMap32):
        return m.lookup(ids)
    return jnp.where(ids >= 0, m[jnp.clip(ids, 0, m.shape[0] - 1)], -1)
