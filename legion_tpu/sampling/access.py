"""Graph access strategies for the sampler.

The reference's random_sample kernel reads adjacency from three places
(operator_impl.cu:224-243): the local GPU's cached sub-CSR, a peer GPU's
cached sub-CSR over NVLink, or the pinned-host full CSR over UVA/PCIe. Here
these become access strategies behind one interface:

  DeviceCSRAccess : full CSR in HBM (in-memory mode)
  CachedTopoAccess: hot sub-CSR in HBM (UnifiedCache) + batched host
                    neighbor sampling for misses via pure_callback — the
                    UVA-fallback analog. The host draws the neighbors
                    directly (uniform with replacement) so shapes stay
                    static and host work is O(misses x fanout).

Multi-card peer reads live in the cache layer's collective path
(cache/collective.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion_tpu.graph import DeviceCSR


def _gather(arr, idx, valid, fill):
    safe = jnp.clip(idx, 0, arr.shape[0] - 1)
    return jnp.where(valid, arr[safe], fill)


class GraphAccess:
    """Interface: draw `fanout` neighbors per frontier vertex."""

    num_nodes: int

    def sample_neighbors(self, frontier: jax.Array, fanout: int,
                         key: jax.Array) -> jax.Array:
        """frontier [F] int32 (-1 pad) -> neighbors [fanout*F] int32 in
        FANOUT-MAJOR lane order (draw f of frontier slot i at lane
        f*F + i), -1 where the frontier slot is invalid or the vertex has
        no edges. Fanout-major keeps the downstream [fanout, F, d]
        aggregation reshape tile-aligned (ops/hop_agg.py)."""
        raise NotImplementedError

    # --- split-draw API (staged per-hop pipeline, train.py) ------------
    # Runtimes without in-program host callbacks split each hop into a
    # device program (lookup) + a host draw for the unserved slots +
    # a merge in the next program. sample_neighbors(frontier, fanout,
    # key) must equal merge_draws(lookup(...), host draws with
    # host_seed(key)) EXACTLY — same RNG consumption — so the staged and
    # callback paths stay loss-identical.

    needs_host_draws: bool = False

    def lookup(self, frontier: jax.Array, fanout: int, key: jax.Array
               ) -> Tuple[jax.Array, jax.Array]:
        """Device-only draws: (lanes [fanout*F] fanout-major, served [F]
        bool). served[i] False => slot i's draws must come from the host
        (with this access's host_seed/host_draw)."""
        lanes = self.sample_neighbors(frontier, fanout, key)
        return lanes, frontier >= 0

    def host_seed(self, key: jax.Array) -> jax.Array:
        """The int32 seed the in-program callback path would hand the
        host sampler for this hop's key (traced; computed in-program)."""
        raise NotImplementedError

    def host_draw(self, frontier: np.ndarray, fanout: int,
                  seed: int) -> np.ndarray:
        """Host-side draws [F, fanout] for the (-1-masked) miss frontier;
        must be the exact function the callback path invokes."""
        raise NotImplementedError

    @staticmethod
    def merge_draws(lanes: jax.Array, served: jax.Array,
                    host_nbr: jax.Array, fanout: int) -> jax.Array:
        """Combine device lanes with host draws ([F, fanout]) exactly as
        the callback path's jnp.where does."""
        return jnp.where(jnp.tile(served, fanout), lanes,
                         host_nbr.T.reshape(-1))


class _HostRef:
    """Identity-hashed holder so host numpy arrays can ride in pytree aux
    data (static under jit)."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array

    def __hash__(self):
        return id(self.array)

    def __eq__(self, other):
        return isinstance(other, _HostRef) and other.array is self.array


@jax.tree_util.register_pytree_node_class
class DeviceCSRAccess(GraphAccess):
    def __init__(self, csr: DeviceCSR):
        self.csr = csr
        self.num_nodes = csr.num_nodes

    def tree_flatten(self):
        return (self.csr,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def sample_neighbors(self, frontier, fanout, key):
        csr = self.csr
        fvalid = frontier >= 0
        row_start = _gather(csr.indptr, frontier, fvalid, 0)
        row_end = _gather(csr.indptr[1:], frontier, fvalid, 0)
        deg = jnp.where(fvalid, (row_end - row_start).astype(jnp.int32), 0)
        F = frontier.shape[0]
        r = jax.random.randint(key, (fanout, F), 0,
                               jnp.maximum(deg, 1)[None, :],
                               dtype=jnp.int32)
        nbr_pos = row_start[None, :] + r.astype(row_start.dtype)
        nbr = _gather(self.csr.indices, nbr_pos.reshape(-1),
                      jnp.tile(deg > 0, fanout), -1)
        return nbr


@jax.tree_util.register_pytree_node_class
class WindowedCSRAccess(GraphAccess):
    """HBM CSR with block-windowed draws.

    All `fanout` draws of a frontier vertex come from one contiguous CSR
    row, so instead of fanout element-gathers per vertex we gather ONE
    aligned W-wide block of the edge array per vertex and draw inside it:

      1. r0 ~ U[0, deg) picks the block b = (row_start + r0) // W;
      2. the draws are uniform over I = [row_start, row_end) ∩ block b.

    P(block) = |I|/deg and P(elem | block) = 1/|I|, so every neighbor has
    exactly 1/deg marginal probability per draw — the same marginal as
    the reference's per-slot uniform draws (operator_impl.cu:235-243).
    The difference: one vertex's draws within a step are correlated
    (confined to <= W neighbors); across steps blocks re-randomize. In
    exchange the hop's edge read drops from E_k random offsets to F_k row
    reads (fanout times fewer offsets). Whether that wins over exact
    draws on the GPU is not measured yet (SamplerConfig.neighbor_window).

    Layout: `row_pairs` [V, 2] = (row_start, degree) merges the two
    indptr gathers into one row gather; `indices2d` [ceil(E/W), W] is the
    edge array padded to a block multiple (bitcast reshape of the flat
    layout).
    """

    def __init__(self, row_pairs: jax.Array, indices2d: jax.Array,
                 num_nodes: int, num_edges: int):
        self.row_pairs = row_pairs
        self.indices2d = indices2d
        self.num_nodes = num_nodes
        self.num_edges = num_edges

    @property
    def window(self) -> int:
        return int(self.indices2d.shape[1])

    @classmethod
    def from_csr(cls, csr: DeviceCSR, window: int = 64
                 ) -> "WindowedCSRAccess":
        assert window & (window - 1) == 0, "window must be a power of two"
        # keep edge offsets in the CSR's own offset dtype: graphs with
        # >= 2**31 edges carry int64 indptr (graph.py downcasts only when
        # E fits int32), and a silent int32 wrap here would corrupt draws
        odt = jnp.int64 if csr.num_edges >= 2 ** 31 else jnp.int32
        starts = csr.indptr[:-1].astype(odt)
        deg = (csr.indptr[1:] - csr.indptr[:-1]).astype(odt)
        row_pairs = jnp.stack([starts, deg], axis=1)
        E = csr.num_edges
        pE = -(-E // window) * window
        flat = jnp.pad(csr.indices, (0, pE - E), constant_values=-1)
        return cls(row_pairs, flat.reshape(-1, window), csr.num_nodes, E)

    def tree_flatten(self):
        return ((self.row_pairs, self.indices2d),
                (self.num_nodes, self.num_edges))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])

    def sample_neighbors(self, frontier, fanout, key):
        W = self.window
        F = frontier.shape[0]
        fvalid = frontier >= 0
        pd = self.row_pairs[jnp.clip(frontier, 0, self.num_nodes - 1)]
        row_start = jnp.where(fvalid, pd[:, 0], 0)
        deg = jnp.where(fvalid, pd[:, 1], 0)
        ok = deg > 0
        k0, k1 = jax.random.split(key)
        # r0 picks the block; degrees above int32 (possible only on
        # pathological >2B-degree rows) clip, slightly biasing block
        # choice on those rows while keeping within-block draws exact
        deg32 = jnp.minimum(deg, jnp.asarray(2 ** 31 - 1, deg.dtype)
                            ).astype(jnp.int32)
        r0 = jax.random.randint(k0, (F,), 0, jnp.maximum(deg32, 1),
                                dtype=jnp.int32)
        # block math stays in the pair table's offset dtype (int64 for
        # >=2**31-edge graphs); per-block offsets then fit int32
        blk = (row_start + r0.astype(row_start.dtype)) // W
        base = blk * W
        lo = (jnp.maximum(base, row_start) - base).astype(jnp.int32)
        hi = (jnp.minimum(base + W, row_start + deg) - base).astype(
            jnp.int32)
        m = jnp.maximum(hi - lo, 1)
        # within-block offsets of the draws, fanout-major
        off = lo[None, :] + jax.random.randint(k1, (fanout, F), 0,
                                               m[None, :], dtype=jnp.int32)
        rows = self.indices2d[blk]                         # [F, W] row read
        sel = off[..., None] == jnp.arange(W, dtype=jnp.int32)
        cand = jnp.sum(jnp.where(sel, rows[None, :, :], 0), axis=-1,
                       dtype=jnp.int32)
        cand = jnp.where(ok[None, :], cand, -1)
        return cand.reshape(-1)


@jax.tree_util.register_pytree_node_class
class CachedTopoAccess(GraphAccess):
    """Hot sub-CSR in HBM + host fallback draws.

    Parity: topo_cache_hit + random_sample cached branch
    (cache_impl.cuh:89-101, operator_impl.cu:224-243); host fallback =
    the UVA slot [partition_count] branch.
    """

    def __init__(self, row_map: jax.Array, sub_indptr: jax.Array,
                 sub_indices: jax.Array, host_indptr: np.ndarray,
                 host_indices: np.ndarray):
        self.row_map = row_map
        self.sub_indptr = sub_indptr
        self.sub_indices = sub_indices
        self.host_indptr = host_indptr
        self.host_indices = host_indices
        self.num_nodes = int(row_map.shape[0])

    def tree_flatten(self):
        return ((self.row_map, self.sub_indptr, self.sub_indices),
                (_HostRef(self.host_indptr), _HostRef(self.host_indices)))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0].array,
                   aux[1].array)

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
        """Device draws from the hot sub-CSR; served = cache-resident
        rows (deg-0 resident rows produce -1 lanes but need no host
        draw)."""
        F = frontier.shape[0]
        fvalid = frontier >= 0
        row = _gather(self.row_map, frontier, fvalid, -1)
        hit = row >= 0
        rowc = jnp.clip(row, 0, self.sub_indptr.shape[0] - 2)
        rs = self.sub_indptr[rowc]
        re = self.sub_indptr[rowc + 1]
        deg = jnp.where(hit, (re - rs).astype(jnp.int32), 0)
        r = jax.random.randint(key, (fanout, F), 0,
                               jnp.maximum(deg, 1)[None, :],
                               dtype=jnp.int32)
        nbr_pos = rs[None, :] + r.astype(rs.dtype)
        nbr_hit = _gather(self.sub_indices, nbr_pos.reshape(-1),
                          jnp.tile(deg > 0, fanout), -1)
        return nbr_hit, hit

    def sample_neighbors(self, frontier, fanout, key):
        F = frontier.shape[0]
        lanes, hit = self.lookup(frontier, fanout, key)

        # host branch: one batched callback for the misses
        miss_frontier = jnp.where(hit, -1, frontier)
        seed = self.host_seed(key)
        nbr_miss = jax.pure_callback(
            lambda f, s: self._host_draw(f, fanout, s),
            jax.ShapeDtypeStruct((F, fanout), jnp.int32),
            miss_frontier, seed, vmap_method="sequential")
        return self.merge_draws(lanes, hit, nbr_miss, fanout)
