"""Cache cost model: split cache bytes between feature and topology caches.

Reference parity: UnifiedCache::CandidateSelection + CostModel
(cache.cu:360-551). The reference sweeps alpha in MIN_INTERVAL=0.01 steps of
the clique's aggregate cache memory (cache_impl.cuh:30) and picks the split
maximizing estimated saved PCIe transactions; its topology term multiplies
*PCM hardware counters that are disabled in the release* (server.cu:106), so
the released system degenerates to all-feature caching. We keep the sweep
but score both terms with measured quantities:

  feat_saved(c)  = sum of the c hottest vertices' batch-hit counts
                   x feature row bytes
  topo_saved(c)  = sum of the c hottest vertices' expansion counts
                   x their CSR row bytes (8 + 4*degree, GetEdgeMem
                   cache.cu:494-505)

Both are expected host-fetch bytes avoided per presampled step — the
analog of saved PCIe transactions, with the dead PCM path made live.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion_tpu.graph import DeviceCSR


@dataclass
class CostModelResult:
    feature_capacity: int        # rows of the feature cache
    topo_capacity: int           # rows (vertices) of the topology cache
    alpha: float                 # fraction of bytes given to features
    feature_order: jax.Array     # QF: vertex ids by feature hotness desc
    topo_order: jax.Array        # QT: vertex ids by topo hotness desc
    est_feat_saved_bytes: float
    est_topo_saved_bytes: float


def _order_and_prefix(node_access, edge_access, degrees, feat_row_bytes):
    # HOST NumPy on purpose: this runs ONCE at setup on [V] arrays, where a
    # jitted version would add a compile for work CPU argsort/cumsum does
    # in milliseconds
    na = np.asarray(node_access)
    ea = np.asarray(edge_access)
    deg = np.asarray(degrees)
    qf = np.argsort(-na.astype(np.int64), kind="stable")
    qt = np.argsort(-ea.astype(np.int64), kind="stable")
    feat_saved = np.cumsum(na[qf].astype(np.float64)) * feat_row_bytes
    row_bytes = 8.0 + 4.0 * deg.astype(np.float64)
    topo_saved = np.cumsum(ea[qt].astype(np.float64) * row_bytes[qt])
    topo_bytes = np.cumsum(row_bytes[qt])
    return qf, qt, feat_saved, topo_saved, topo_bytes


def plan_cache(node_access: jax.Array, edge_access: jax.Array,
               csr, cache_bytes: int, feat_dim: int,
               alpha_step: float = 0.01,
               group_size: int = 1,
               bytes_per_feat: int = 4) -> CostModelResult:
    """Pick (feature_capacity, topo_capacity) maximizing saved bytes.

    ``csr`` may be a DeviceCSR or a [V] degree array (host datasets).
    group_size (Kg) multiplies the budget: a cache group aggregates its
    members' HBM like the reference's NVLink clique (cache.cu:375-389);
    capacities returned are GROUP totals (split across members by the
    UnifiedCache layout). bytes_per_feat=2 for bf16 cache storage —
    DOUBLES the rows a byte budget holds.
    """
    if isinstance(csr, DeviceCSR):
        degrees = csr.degrees()
        V = csr.num_nodes
    else:
        degrees = jnp.asarray(csr)
        V = int(degrees.shape[0])
    feat_row_bytes = bytes_per_feat * feat_dim
    qf, qt, feat_saved, topo_saved, topo_bytes = _order_and_prefix(
        node_access, edge_access, degrees, float(feat_row_bytes))
    feat_saved = np.asarray(feat_saved)
    topo_saved = np.asarray(topo_saved)
    topo_bytes = np.asarray(topo_bytes)

    total = cache_bytes * group_size
    best = (-1.0, 0, 0, 0.0)  # (saved, feat_cap, topo_cap, alpha)
    alphas = np.arange(0.0, 1.0 + 1e-9, alpha_step)
    for alpha in alphas:
        feat_cap = min(int(alpha * total) // feat_row_bytes, V)
        fs = feat_saved[feat_cap - 1] if feat_cap > 0 else 0.0
        topo_budget = total - feat_cap * feat_row_bytes
        topo_cap = int(np.searchsorted(topo_bytes, topo_budget,
                                       side="right"))
        topo_cap = min(topo_cap, V)
        ts = topo_saved[topo_cap - 1] if topo_cap > 0 else 0.0
        saved = fs + ts
        if saved > best[0]:
            best = (saved, feat_cap, topo_cap, float(alpha))
    _, feat_cap, topo_cap, alpha = best
    fs = float(feat_saved[feat_cap - 1]) if feat_cap > 0 else 0.0
    ts = float(topo_saved[topo_cap - 1]) if topo_cap > 0 else 0.0
    return CostModelResult(
        feature_capacity=feat_cap, topo_capacity=topo_cap, alpha=alpha,
        feature_order=qf, topo_order=qt,
        est_feat_saved_bytes=fs, est_topo_saved_bytes=ts)
