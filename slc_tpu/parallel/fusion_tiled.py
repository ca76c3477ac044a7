"""Distributed bundle adjustment: landmarks sharded across devices.

Every Schur term is a sum over landmarks (slc_tpu.fusion), so the
distribution is: each device owns a landmark shard, reduces its local
Gauss-Newton blocks, one `psum` forms the global reduced camera system,
the tiny (6S x 6S) solve is replicated, and landmark back-substitution
stays local. Across hosts this is the data parallelism of SURVEY.md
§2's distributed-solver row.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slc_tpu import fusion

LM = "lm"


def fusion_mesh(devices=None) -> Mesh:
    import numpy as np
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (LM,))


def shard_landmarks(mesh: Mesh, obs, mask, landmarks=None):
    """Place (S, L, 3) obs / (S, L) mask / (L, 3) landmarks with L
    sharded over the mesh."""
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    out = [put(obs, P(None, LM, None)), put(mask, P(None, LM))]
    if landmarks is not None:
        out.append(put(landmarks, P(LM, None)))
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("mesh", "iters"))
def tiled_fuse_scans(obs: jax.Array, mask: jax.Array, mesh: Mesh,
                     init_rot: Optional[jax.Array] = None,
                     init_trans: Optional[jax.Array] = None,
                     iters: int = 10, damping: float = 1e-6):
    """Distributed fuse_scans; numerically identical to the single-device
    solver (the psum-reduced normal equations are exact sums)."""
    s = obs.shape[0]
    if init_rot is None:
        init_rot = jnp.broadcast_to(jnp.eye(3, dtype=obs.dtype), (s, 3, 3))
    if init_trans is None:
        init_trans = jnp.zeros((s, 3), obs.dtype)

    @fusion._highest_precision
    def f(obs_l, mask_l, rot, trans):
        pred = jnp.einsum("sij,slj->sli", rot, obs_l) + trans[:, None, :]
        lm = (pred * mask_l[..., None]).sum(0) \
            / jnp.maximum(mask_l.sum(0)[:, None], 1.0)

        def body(_, carry):
            r, t, x = carry
            return fusion.gn_step(
                r, t, x, obs_l, mask_l, damping,
                reduce_fn=lambda v: jax.lax.psum(v, LM))

        rot_f, trans_f, lm_f = jax.lax.fori_loop(
            0, iters, body, (rot, trans, lm))
        return rot_f, trans_f, lm_f

    return shard_map(
        f, mesh=mesh,
        in_specs=(P(None, LM, None), P(None, LM), P(), P()),
        out_specs=(P(), P(), P(LM, None)))(obs, mask, init_rot, init_trans)
