"""Tracker-state checkpoint / resume.

The reference has no checkpointing; its dynamic loop is restart-from-
zero only (SURVEY.md §5). The carried state is tiny and explicit
(TrackerState: P, stripW, stripB, z, frame_idx — CCalculation.cpp:
603-606, :656-658, :774), so any frame is a resume point. Each
checkpoint is one .npz file written through an atomic rename, so a crash
mid-save never corrupts the latest checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from slc_tpu.dynamic import TrackerState

_FIELDS = ("proj_u", "strip_w", "strip_b", "z", "frame_idx")


def save_state(path: str, state: TrackerState) -> str:
    """Save a TrackerState; returns the path written (``path`` with an
    .npz suffix)."""
    state = jax.device_get(state)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(getattr(state, f)) for f in _FIELDS})
    os.replace(tmp, path)
    return path


def load_state(path: str) -> TrackerState:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        data = {k: f[k] for k in _FIELDS}
    return TrackerState(
        proj_u=jnp.asarray(data["proj_u"]),
        strip_w=jnp.asarray(data["strip_w"]),
        strip_b=jnp.asarray(data["strip_b"]),
        z=jnp.asarray(data["z"]),
        frame_idx=jnp.asarray(data["frame_idx"]))


def latest_checkpoint(ckpt_dir: str, prefix: str = "frame_"
                      ) -> Optional[str]:
    """Find the newest ``<prefix><N>`` checkpoint under ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)(?:\.npz)?", name)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
