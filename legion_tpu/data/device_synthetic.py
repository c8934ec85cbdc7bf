"""On-device synthetic dataset generation.

Builds a power-law graph, features, and labels entirely in HBM with XLA ops
(random -> inverse-CDF power-law destinations -> sort -> searchsorted CSR).
A 120M-edge products-scale graph is generated with no host->device
transfer, which keeps benchmark set-up (BASELINE.md) off the host.

The id scramble uses a multiplicative bijection (x * prime mod V, prime
coprime to V) instead of a stored permutation, so hot-ranked vertices are
scattered across the id space like reordered webgraphs — same role as the
host generator's rng.permutation (synthetic.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion_tpu.config import DatasetMeta
from legion_tpu.graph import DeviceCSR


def _coprime(v: int) -> int:
    p = 1_000_003
    while math.gcd(p, v) != 1:
        p += 2
    return p


@partial(jax.jit, static_argnums=(1, 2, 3, 4), donate_argnums=())
def _gen_graph(key, V: int, E: int, alpha: float, scramble: int):
    k1, k2 = jax.random.split(key)
    src = jax.random.randint(k1, (E,), 0, V, dtype=jnp.int32)
    u = jax.random.uniform(k2, (E,), dtype=jnp.float32)
    # inverse-CDF power-law rank popularity q(r) ~ r^-alpha with alpha < 1
    # (rank exponent, NOT the degree-distribution exponent): CDF ~ r^(1-alpha)
    # so r = V * u^(1/(1-alpha)). alpha=0.8 puts ~40% of edges on the top 1%
    # of vertices — realistic webgraph in-degree skew.
    ranks = V * u ** (1.0 / (1.0 - alpha))
    dst_rank = jnp.clip(ranks.astype(jnp.int32), 0, V - 1)
    dst = ((dst_rank.astype(jnp.int64) * scramble) % V).astype(jnp.int32)
    # self-loops are dropped in the reference converter
    # (gen_legion_xtrapulp_fomat.cpp:90); shift instead to keep E static
    dst = jnp.where(dst == src, (dst + 1) % V, dst)
    src_s, dst_s = jax.lax.sort_key_val(src, dst)
    indptr = jnp.searchsorted(src_s, jnp.arange(V + 1, dtype=jnp.int32)
                              ).astype(jnp.int32)
    return indptr, dst_s


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _gen_features(key, V: int, feat_dim: int, num_classes: int,
                  scramble: int):
    labels = ((jnp.arange(V, dtype=jnp.int64) * scramble)
              % num_classes).astype(jnp.int32)
    k1, k2 = jax.random.split(key)
    protos = jax.random.normal(k1, (num_classes, feat_dim), jnp.float32)
    feats = protos[labels] + jax.random.normal(
        k2, (V, feat_dim), jnp.float32)
    return feats, labels


@dataclass
class DeviceDataset:
    """Device-resident dataset implementing the Trainer protocol."""

    meta: DatasetMeta
    csr: DeviceCSR
    features: jax.Array
    labels: jax.Array
    train_ids: np.ndarray
    valid_ids: np.ndarray
    test_ids: np.ndarray

    def device_arrays(self):
        return self.csr, self.features, self.labels

    def seed_sets(self, n_dev: int
                  ) -> Tuple[List[np.ndarray], List[np.ndarray],
                             List[np.ndarray]]:
        def split(ids):
            if n_dev == 1:
                return [ids]
            return [ids[ids % n_dev == d] for d in range(n_dev)]
        return split(self.train_ids), split(self.valid_ids), \
            split(self.test_ids)


def synthesize_device_dataset(
    num_nodes: int = 2_400_000,
    num_edges: int = 120_000_000,
    feature_dim: int = 100,
    num_classes: int = 32,
    batch_size: int = 8000,
    train_frac: float = 0.08,
    valid_size: int = 20_000,
    test_size: int = 20_000,
    alpha: float = 0.8,
    seed: int = 0,
) -> DeviceDataset:
    scramble = _coprime(num_nodes)
    key = jax.random.PRNGKey(seed)
    kg, kf = jax.random.split(key)
    indptr, indices = _gen_graph(kg, num_nodes, num_edges, alpha, scramble)
    feats, labels = _gen_features(kf, num_nodes, feature_dim, num_classes,
                                  scramble)
    csr = DeviceCSR(indptr=indptr, indices=indices, num_nodes=num_nodes,
                    num_edges=num_edges)

    # seed sets: disjoint distinct ids via the same multiplicative bijection
    # (host side, but tiny)
    n_train = int(num_nodes * train_frac)
    p = _coprime(num_nodes)
    all_ids = (np.arange(n_train + valid_size + test_size,
                         dtype=np.int64) * p) % num_nodes
    all_ids = all_ids.astype(np.int32)
    meta = DatasetMeta(
        path="device://synthetic", batch_size=batch_size,
        num_nodes=num_nodes, num_edges=num_edges, feature_dim=feature_dim,
        train_size=n_train, valid_size=valid_size, test_size=test_size,
        num_classes=num_classes, name="device_synthetic")
    return DeviceDataset(
        meta=meta, csr=csr, features=feats, labels=labels,
        train_ids=all_ids[:n_train],
        valid_ids=all_ids[n_train:n_train + valid_size],
        test_ids=all_ids[n_train + valid_size:])
