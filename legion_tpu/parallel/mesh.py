"""Device mesh construction.

Legion's GPU topology (Kc NVLink cliques x Kg GPUs, detected via nvidia-smi
in legion_server.py:23-37) maps to a 2-axis device mesh:

  axis "clique" (Kc): independent cache groups — data-parallel across, no
      intra-step communication except gradient reduction;
  axis "member" (Kg): NVLink peers sharing an aggregated cache — feature
      cache interleaved over this axis (cache_impl.cuh:104-109), reads via
      collective gathers.

Training is data-parallel over BOTH axes (the reference's DDP over all 8
GPUs, legion_graphsage.py:139-140); the distinction only matters to the
cache layer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from legion_tpu.config import MeshConfig

DP_AXES = ("clique", "member")


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[jax.Device]] = None,
              num_hosts: int = 1) -> Mesh:
    """Build the device mesh.

    Single host: ("clique", "member") — both NVLink. Multi-host: a leading
    "host" axis (the network) is added; per-host graph partitions and seed shards
    ride it, gradients pmean across it, cache collectives stay inside the
    single-host axes. Under `jax.distributed` each process contributes its local
    devices; `jax.devices()` already enumerates the global ordering.
    """
    if devices is None:
        devices = jax.devices()
    if config is None:
        config = MeshConfig.for_devices(len(devices) // num_hosts)
    n = config.num_devices * num_hosts
    assert n <= len(devices), (
        f"mesh needs {n} devices, have {len(devices)}")
    if num_hosts > 1:
        arr = np.asarray(devices[:n]).reshape(
            num_hosts, config.num_cliques, config.clique_size)
        return Mesh(arr, ("host",) + DP_AXES)
    arr = np.asarray(devices[:n]).reshape(config.num_cliques,
                                          config.clique_size)
    return Mesh(arr, DP_AXES)


def dp_axes(mesh: Mesh):
    """All mesh axes are data-parallel for training."""
    return tuple(mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n
