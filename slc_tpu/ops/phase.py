"""N-step phase-shift fringe decoding.

Generalizes the reference 4-step decoder (DynaFrame/CDecodePhase.cpp:48-80).
The assumed fringe model, documented in the reference at
DynaFrame/CDecodePhase.cpp:59-62, is

    I_k(x) = (sin(phi(x) + k * 2*pi/N) + 1) * 127        k = 0..N-1

For N steps with shifts d_k = 2*pi*k/N:

    sum_k I_k cos(d_k) = (N/2) * B * sin(phi)
    sum_k I_k sin(d_k) = (N/2) * B * cos(phi)

so for N=4 this reduces exactly to the reference's
``sin = (I0 - I2)/2``, ``cos = (I1 - I3)/2`` (CDecodePhase.cpp:64-65).

The wrapped result follows the reference pixel convention
(CDecodePhase.cpp:67-74): angle in degrees in [0, 360), then

    pix = angle/360 * T + 0.5 ;   pix > T  ->  pix -= T

yielding a wrapped projector offset in (0, T].
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def phase_sincos(images: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(N, H, W) fringe stack -> (sin_term, cos_term), each (H, W) float32.

    ``sin_term = (2/N) sum I_k cos(2 pi k / N)`` equals ``B sin(phi)``;
    ``cos_term`` likewise equals ``B cos(phi)`` — the N-step least-squares
    phase estimator. For N=4 these are exactly the reference's sinValue /
    cosValue (CDecodePhase.cpp:64-65).
    """
    n = images.shape[0]
    if n < 3:
        # Two shifts 180 degrees apart leave the cos term identically 0.
        raise ValueError(f"N-step phase decode needs n_steps >= 3, got {n}")
    imgs = images.astype(jnp.float32)
    k = jnp.arange(n, dtype=jnp.float32) * (2.0 * jnp.pi / n)
    coef_shape = (n,) + (1,) * (imgs.ndim - 1)
    sin_term = jnp.sum(imgs * jnp.cos(k).reshape(coef_shape), axis=0) * (2.0 / n)
    cos_term = jnp.sum(imgs * jnp.sin(k).reshape(coef_shape), axis=0) * (2.0 / n)
    return sin_term, cos_term


def wrapped_phase_to_pixels(sin_term: jax.Array, cos_term: jax.Array,
                            period: float) -> jax.Array:
    """atan2 -> wrapped projector-px offset in (0, T], reference convention
    (CDecodePhase.cpp:67-74). The reference uses cvFastArctan (a ~0.3 deg
    LUT approximation); we use exact atan2, which is strictly more
    accurate and costs nothing in a memory-bound decode."""
    ang = jnp.arctan2(sin_term, cos_term)              # [-pi, pi]
    ang = jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)  # [0, 2*pi)
    pix = ang * (jnp.float32(period) / jnp.float32(2.0 * jnp.pi)) + 0.5
    return jnp.where(pix > period, pix - period, pix)


@functools.partial(jax.jit, static_argnames=("period",))
def decode_phase(images: jax.Array, period: float) -> jax.Array:
    """Full N-step phase decode: (N, H, W) uint8/float -> (H, W) float32
    wrapped fringe coordinate in (0, T] (cf. CDecodePhase.cpp:48-80)."""
    s, c = phase_sincos(images)
    return wrapped_phase_to_pixels(s, c, period)


def modulation(images: jax.Array) -> jax.Array:
    """Fringe modulation amplitude B = |B e^{i phi}| per pixel — the
    standard validity signal (absent in the reference, which instead
    relies on the P==0 hole convention, CCalculation.cpp:678-682).
    Pixels with low modulation carry no fringe signal."""
    s, c = phase_sincos(images)
    return jnp.sqrt(s * s + c * c)
