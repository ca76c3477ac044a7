"""Spatial filters: box blur and bilateral depth filtering.

* 3x3 box blur replicates ``cv::blur(src, dst, Size(3,3))`` applied to the
  delta-P map in the reference (DynaFrame/CCalculation.cpp:648-650),
  including OpenCV's default BORDER_REFLECT_101 border (jnp.pad
  mode='reflect').
* The bilateral filter reproduces the behavior of the reference's depth
  post-filter ``bilateralFilter(d=3, sigmaColor=10, sigmaSpace=25)``
  (DynaFrame/depthMapUtils.cpp:179) as a vectorized stencil, with a
  hole-aware weight so invalid (z == 0) pixels neither bleed nor get
  filled.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def box_blur(x: jax.Array, size: int = 3) -> jax.Array:
    """Separable mean filter with REFLECT_101 borders, matching cv::blur
    defaults (used at CCalculation.cpp:650 with Size(3,3)).

    Direct shifted adds, not differences of running sums: each output
    sums its own ``size`` neighbours in a fixed order, so its rounding
    does not grow with the image width, and a tile with a halo of
    ``size // 2`` gives the same bits as the whole frame
    (slc_tpu.parallel.tiled)."""
    r = size // 2
    h, w = x.shape
    pad = jnp.pad(x, ((r, r), (0, 0)), mode="reflect")
    x = functools.reduce(jnp.add, [pad[k:k + h] for k in range(size)])
    pad = jnp.pad(x, ((0, 0), (r, r)), mode="reflect")
    x = functools.reduce(jnp.add, [pad[:, k:k + w] for k in range(size)])
    return x / jnp.asarray(size * size, x.dtype)


box_blur_3x3 = functools.partial(box_blur, size=3)


@functools.partial(jax.jit, static_argnames=("radius", "hole_aware"))
def bilateral_filter(img: jax.Array, radius: int = 1,
                     sigma_color: float = 10.0,
                     sigma_space: float = 25.0,
                     hole_aware: bool = True) -> jax.Array:
    """Brute-force bilateral filter over a (2r+1)^2 stencil.

    Matches the parameterization of the reference call
    (depthMapUtils.cpp:179: d=3 -> radius 1, sigmaColor=10, sigmaSpace=25).
    With ``hole_aware`` (framework improvement), pixels where img == 0 are
    treated as missing: they get zero weight and remain zero.
    Neighbors outside the image are missing too, so the left and right
    (top and bottom) borders never mix.
    """
    x = img.astype(jnp.float32)
    h, w = x.shape
    inv2sc = jnp.float32(-0.5 / (sigma_color * sigma_color))
    inv2ss = jnp.float32(-0.5 / (sigma_space * sigma_space))
    valid = ((x != 0) if hole_aware else jnp.ones_like(x, bool)
             ).astype(jnp.float32)
    pad = ((radius, radius), (radius, radius))
    xp = jnp.pad(x, pad)
    vp = jnp.pad(valid, pad)

    num = jnp.zeros_like(x)
    den = jnp.zeros_like(x)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            win = (slice(radius + dy, radius + dy + h),
                   slice(radius + dx, radius + dx + w))
            v = xp[win]
            wgt = jnp.exp((v - x) * (v - x) * inv2sc
                          + jnp.float32(dy * dy + dx * dx) * inv2ss) * vp[win]
            num = num + wgt * v
            den = den + wgt
    out = num / jnp.maximum(den, 1e-12)
    if hole_aware:
        out = jnp.where(valid > 0, out, 0.0)
    return out
