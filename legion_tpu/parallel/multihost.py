"""Multi-host (N>=2) support.

Reference scope: Legion scales inside one machine (8 GPUs); the "scale-out"
story is the offline XtraPuLP partitioning of seeds per NVLink clique
(storage_management.cu:171-203). This rebuild's multi-host design
(SURVEY.md §7 stage 6):

  - mesh ("host", "clique", "member"): "host" rides the network and is
    purely data-parallel (gradient pmean); cache collectives stay inside
    the NVLink axes, so no per-step graph data crosses the network;
  - each host trains on its own partition's seeds (the `partition` file
    from tools/prepare.py, min-partition step rule preserved by
    Schedule.build);
  - storage is per-host: every host loads the full (or its partition's)
    CSR + features into its own host RAM / HBM — exactly the reference's
    per-machine storage model.

On a real cluster call `initialize()` per process before touching jax; the
same code paths are validated in the tests on a virtual mesh (host axis
over CPU devices), which exercises identical shardings/collectives minus
the network transport.
"""

from __future__ import annotations

from typing import Optional

import jax

from legion_tpu.config import MeshConfig
from legion_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed bring-up (no-op if already initialized)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise


def make_multihost_mesh(clique_size: Optional[int] = None,
                        num_hosts: Optional[int] = None
                        ) -> jax.sharding.Mesh:
    """Mesh over all global devices with a leading "host" axis."""
    devices = jax.devices()
    if num_hosts is None:
        num_hosts = max(jax.process_count(), 1)
    per_host = len(devices) // num_hosts
    cfg = MeshConfig.for_devices(per_host, clique_size=clique_size)
    return make_mesh(cfg, devices, num_hosts=num_hosts)
