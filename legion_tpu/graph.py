"""CSR graph containers.

Reference parity: src/storage/graph_storage.cu (CompleteGraphStorage) holds the
full CSR in pinned host memory with UVA device pointers; per-GPU sub-CSR caches
are layered on top. Here residency is explicit instead of UVA:

  - ``CSRGraph`` (numpy, host): the authoritative storage, mmap-backed or
    in-RAM, playing the role of the pinned host CSR
    (storage_management.cu:100-115).
  - ``DeviceCSR`` (jax, HBM): a device-resident CSR (either the whole graph
    when it fits, or the hot sub-CSR built by the cache layer —
    graph_storage.cu:76-111).

Offsets (indptr) are int64 like the reference's ``edge_src`` file
(dataset/README.md:3-10); indices int32.  When the edge count fits int32 we
downcast offsets on-device to halve HBM traffic in the sampler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class CSRGraph:
    """Host-resident CSR. indptr: int64 [V+1]; indices: int32 [E]."""

    indptr: np.ndarray
    indices: np.ndarray

    def __post_init__(self):
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr.dtype == np.int64
        assert self.indices.dtype == np.int32

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   drop_self_loops: bool = True) -> "CSRGraph":
        """Build CSR from an edge list (reference:
        dataset/gen_legion_xtrapulp_fomat.cpp:143-183; self-loops dropped
        like :90)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if drop_self_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=num_nodes).astype(np.int64)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, indices=dst.astype(np.int32))

    def to_device(self, sharding: Optional[jax.sharding.Sharding] = None
                  ) -> "DeviceCSR":
        indptr = self.indptr
        if self.num_edges < np.iinfo(np.int32).max:
            indptr = indptr.astype(np.int32)
        put = (lambda x: jax.device_put(x, sharding)) if sharding is not None \
            else jax.device_put
        return DeviceCSR(indptr=put(indptr), indices=put(self.indices),
                         num_nodes=self.num_nodes, num_edges=self.num_edges)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceCSR:
    """HBM-resident CSR (full graph or hot sub-graph)."""

    indptr: jax.Array   # [V+1] int32 or int64
    indices: jax.Array  # [E] int32
    num_nodes: int
    num_edges: int

    def tree_flatten(self):
        return (self.indptr, self.indices), (self.num_nodes, self.num_edges)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, indices = children
        return cls(indptr=indptr, indices=indices, num_nodes=aux[0],
                   num_edges=aux[1])

    def degrees(self) -> jax.Array:
        return self.indptr[1:] - self.indptr[:-1]
