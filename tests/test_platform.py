"""Platform rules: where the compile cache goes, that chip_smoke.py refuses
to run without a GPU, and the host_transfer values."""

import os
import subprocess
import sys

import pytest

from legion_tpu.config import CacheConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(extra)
    return env


@pytest.mark.parametrize("from_env", [False, True],
                         ids=["checkout_default", "env_var"])
def test_compile_cache_dir(from_env, tmp_path):
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} \
        if from_env else {}
    out = subprocess.run(
        [sys.executable, "-c",
         "import legion_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=_env(**extra), cwd=tmp_path, capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()[-1]
    want = str(tmp_path / "cc") if from_env else os.path.join(ROOT,
                                                              ".jax_cache")
    assert out == want


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_host_transfer_values():
    assert CacheConfig().host_transfer == "callback"
    assert CacheConfig(host_transfer="staged").host_transfer == "staged"
    for bad in ("auto", "sync"):
        with pytest.raises(ValueError, match="host_transfer"):
            CacheConfig(host_transfer=bad)
