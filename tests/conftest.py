"""Test config: run on a virtual 8-device CPU mesh.

Must set env vars before jax initializes (SURVEY.md §7 / multi-device
testing strategy — sharding logic is validated on host CPU devices; the GPU
path is exercised by chip_smoke.py on the card).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# pin the backend even where jax was configured before this file ran
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu" and len(jax.devices()) == 8


@pytest.fixture(scope="session")
def small_dataset():
    from legion_tpu.data import synthesize_dataset
    return synthesize_dataset(num_nodes=2000, avg_degree=8, feature_dim=32,
                              num_classes=5, batch_size=64, seed=7)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
