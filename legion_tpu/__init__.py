"""legion_tpu — a JAX mini-batch GNN training framework for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of RC4ML/Legion (USENIX ATC'23:
"Automatically Pushing the Envelope of Multi-GPU System for Billion-Scale GNN
Training") in JAX/XLA: `shard_map` over `jax.sharding.Mesh` for multi-card
scale, and a C-native host runtime for IO.

Subsystem map (reference parity, see SURVEY.md):
  - data/       Legion-compatible binary dataset IO + synthetic graphs
                (reference: dataset/, storage_management.cu)
  - graph.py    CSR graph containers, host/device residency
                (reference: src/storage/graph_storage.cu)
  - sampling/   multi-hop fanout neighbor sampling, static shapes
                (reference: src/engine/operator_impl.cu)
  - cache/      hotness-driven unified feature/topology cache + cost model
                (reference: src/cache/cache.cu)
  - models/     GraphSAGE / GCN / GAT / link-prediction SAGE
                (reference: training_backend/legion_*.py)
  - ops/        segment/aggregation ops (plain XLA)
  - parallel/   mesh construction, cache groups, collectives
  - pipeline/   async prefetch, train/valid/test scheduling
                (reference: src/engine/ipc_service.cu — obsoleted by
                same-process async dispatch)
  - native/     C++ host runtime (mmap loaders, parallel feature gather,
                edge-list -> CSR converter)

int64 note: billion-edge graphs need 64-bit CSR offsets; we enable JAX x64
at import and keep all floating point math explicitly float32/bfloat16.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: sampler/train-step programs at production
# shapes take long to compile, so executables are cached across processes.
# JAX_COMPILATION_CACHE_DIR, when set, is JAX's own and wins; otherwise the
# cache lives at a fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from legion_tpu.config import (  # noqa: E402
    DatasetMeta,
    SamplerConfig,
    CacheConfig,
    TrainConfig,
    MeshConfig,
    LegionConfig,
)
from legion_tpu.graph import CSRGraph  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DatasetMeta",
    "SamplerConfig",
    "CacheConfig",
    "TrainConfig",
    "MeshConfig",
    "LegionConfig",
    "CSRGraph",
]
