"""Minimal SE(3) utilities for multi-scan registration (float32, jit).

No reference equivalent (the reference is single-scan); used by
slc_tpu.fusion's bundle adjustment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Full float32 for every 3x3 contraction: a GPU may otherwise run a
# float32 matmul in TF32, ~1e-3 relative error on poses and points.
_HIGHEST = jax.lax.Precision.HIGHEST


def hat(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1)], -2)


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = hat(w)
    k2 = jnp.matmul(k, k, precision=_HIGHEST)
    th = jnp.maximum(theta, 1e-12)
    a = jnp.sin(th) / th
    b = (1.0 - jnp.cos(th)) / (th * th)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), k.shape)
    # Small-angle limit: a -> 1, b -> 1/2.
    small = theta < 1e-6
    a = jnp.where(small, 1.0, a)
    b = jnp.where(small, 0.5, b)
    return eye + a * k + b * k2


def exp_se3(xi: jax.Array) -> tuple:
    """(..., 6) twist [t, w] -> (R, t) with the first-order coupling
    (V ~ I; adequate for Gauss-Newton increments)."""
    return exp_so3(xi[..., 3:]), xi[..., :3]


def apply(rot: jax.Array, trans: jax.Array, pts: jax.Array) -> jax.Array:
    """R p + t with broadcasting over leading axes of pts."""
    return jnp.matmul(pts, jnp.swapaxes(rot, -1, -2),
                      precision=_HIGHEST) + trans


def compose(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): first apply 2, then 1."""
    return jnp.matmul(r1, r2, precision=_HIGHEST), apply(r1, t1, t2)


def invert(rot, trans):
    rt = jnp.swapaxes(rot, -1, -2)
    return rt, -jnp.einsum("...ij,...j->...i", rt, trans,
                           precision=_HIGHEST)
