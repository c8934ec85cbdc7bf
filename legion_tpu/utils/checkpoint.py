"""Checkpoint/resume as one ``.npz`` file per step.

The reference has NO checkpointing (SURVEY.md §5 — a crash loses the run and
leaves stale IPC segments behind); this is table stakes for the rebuild.

What is saved: params, optimizer state, the schedule counters, and the base
RNG key — everything needed to resume mid-epoch deterministically. The
position map and eval accumulators are scratch (pos_map is INT32_MAX-clean
between batches by construction) and are re-created on restore.

Layout: ``<path>/step_<N>.npz``, one array per leaf, named by its
``jax.tree_util`` key path. A restore reads the leaves back into the
structure, dtypes and shardings of a fresh Trainer state.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import jax
import numpy as np

_SAVED_KEYS = ("params", "opt_state", "train_ctr", "valid_ctr", "test_ctr",
               "base_key")
_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


def _step_path(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}.npz")


def _flatten(payload: Dict) -> Dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(payload)
    return {jax.tree_util.keystr(p): np.asarray(jax.device_get(x))
            for p, x in leaves}


def save_checkpoint(path: str, state: Dict, step: int) -> None:
    """Write checkpoint for `state` (a Trainer state dict) at `step`."""
    os.makedirs(os.path.abspath(path), exist_ok=True)
    arrays = _flatten({k: state[k] for k in _SAVED_KEYS})
    final = _step_path(path, step)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)      # a crash mid-write leaves no partial step


def latest_step(path: str) -> int:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return -1
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path))
             if m]
    return max(steps, default=-1)


def restore_checkpoint(path: str, trainer, step: int = -1) -> Dict:
    """Restore into a fresh Trainer state (pos_map/metrics re-initialized)."""
    state = trainer.init_state()
    if step < 0:
        step = latest_step(path)
        if step < 0:
            raise FileNotFoundError(f"no checkpoints under {path}")
    template = {k: state[k] for k in _SAVED_KEYS}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(_step_path(path, step)) as f:
        restored = [
            jax.device_put(f[jax.tree_util.keystr(p)].astype(x.dtype),
                           x.sharding)
            for p, x in leaves]
    out = dict(state)
    out.update(jax.tree_util.tree_unflatten(treedef, restored))
    # the inter-batch pipeline carry is scratch: re-sample it for the
    # restored train_ctr (init_state primed it for ctr=0)
    if hasattr(trainer, "prime_carry"):
        out = trainer.prime_carry(out)
    return out
