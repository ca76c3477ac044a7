"""Gray-code decoding.

The reference decodes N-bit Gray code from 2N images (pattern + inverse per
bit): per-bit binarization by image difference (DynaFrame/CDecodeGray.cpp:
150-176), bit assembly (CDecodeGray.cpp:192-199), then a gray->binary LUT
loaded from a text file ``Patterns/vGrayCode.txt`` (CDecodeGray.cpp:113-125),
and finally ``result = bin * period`` with ``period = PRO_W / 2**N``
(CDecodeGray.cpp:200, :183).

Differences from the reference:
* the binarization ``saturate_u8(pattern - inverse) > 0`` is equivalent to
  ``pattern > inverse`` and is computed directly;
* the LUT file is replaced by the closed-form XOR-prefix inverse
  ``bin = gray ^ (gray>>1) ^ (gray>>2) ^ ...`` (log2(N) xors, no gather) —
  verified bit-exact against the reference's vGrayCode.txt in tests;
* everything is one fused elementwise pass, image k contributing bit k
  (LSB-first, matching ``grayCode += 1 << binIdx``, CDecodeGray.cpp:197).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def binary_to_gray(b: jax.Array) -> jax.Array:
    """Standard binary -> reflected-Gray map, g = b ^ (b >> 1). Generates
    the same correspondence as the reference's Patterns/vGrayCode.txt."""
    return b ^ (b >> 1)


def gray_to_binary(g: jax.Array, num_bits: int) -> jax.Array:
    """Inverse Gray map via XOR prefix-scan: log2(num_bits) steps instead
    of the reference's 2**N-entry LUT gather (CDecodeGray.cpp:120-125)."""
    b = g
    shift = 1
    while shift < num_bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def binarize_bits(images: jax.Array, num_bits: int) -> jax.Array:
    """(2N, H, W) image stack (pattern, inverse alternating) -> (N, H, W)
    bool bit planes. Reference semantics (CDecodeGray.cpp:159-171): the
    saturating uint8 subtract ``pattern - inverse`` is > 0 iff
    ``pattern > inverse``."""
    pattern = images[0 : 2 * num_bits : 2]
    inverse = images[1 : 2 * num_bits : 2]
    return pattern > inverse


@functools.partial(jax.jit, static_argnames=("num_bits", "projector_extent"))
def decode_gray(images: jax.Array, num_bits: int,
                projector_extent: int) -> jax.Array:
    """Full Gray decode: (2N, H, W) uint8 -> (H, W) float32 absolute
    projector coordinate ``bin * period`` (CDecodeGray.cpp:179-204).

    ``projector_extent`` is PROJECTOR_RESLINE (or RESROW for horizontal
    codes); ``period = extent / 2**N`` (CDecodeGray.cpp:181-185).
    """
    bits = binarize_bits(images, num_bits)
    weights = (1 << jnp.arange(num_bits, dtype=jnp.int32)).reshape(
        (num_bits,) + (1,) * (bits.ndim - 1))
    gray = jnp.sum(bits.astype(jnp.int32) * weights, axis=0)
    binary = gray_to_binary(gray, num_bits)
    period = projector_extent / (1 << num_bits)
    return binary.astype(jnp.float32) * jnp.float32(period)


def decode_gray_bins(images: jax.Array, num_bits: int) -> jax.Array:
    """Same as :func:`decode_gray` but returning the integer bin index."""
    bits = binarize_bits(images, num_bits)
    weights = (1 << jnp.arange(num_bits, dtype=jnp.int32)).reshape(
        (num_bits,) + (1,) * (bits.ndim - 1))
    gray = jnp.sum(bits.astype(jnp.int32) * weights, axis=0)
    return gray_to_binary(gray, num_bits)
