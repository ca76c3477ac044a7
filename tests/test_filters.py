"""Filters: box blur parity with cv::blur semantics (golden), bilateral
behavior."""

import numpy as np
import pytest
import jax.numpy as jnp

from slc_tpu import golden
from slc_tpu.ops.filters import box_blur, box_blur_3x3, bilateral_filter


def test_box_blur_matches_golden(rng):
    x = rng.normal(size=(33, 47)).astype(np.float32)
    ours = np.asarray(box_blur_3x3(jnp.asarray(x)))
    theirs = golden.box_blur_3x3(x)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_box_blur_wide_rows_match_golden(rng):
    """A 2 MP-wide map of same-signed deltas (a frame of steady motion):
    the rounding of each output must not grow with the row length."""
    x = (0.5 + 0.1 * rng.normal(size=(8, 1632))).astype(np.float32)
    ours = np.asarray(box_blur_3x3(jnp.asarray(x)))
    np.testing.assert_allclose(ours, golden.box_blur_3x3(x), rtol=0,
                               atol=4 * np.finfo(np.float32).eps)


def test_box_blur_preserves_constant(rng):
    x = jnp.full((24, 40), 3.25, jnp.float32)
    np.testing.assert_allclose(np.asarray(box_blur(x, 5)), 3.25, atol=1e-5)


def test_bilateral_smooths_noise_keeps_edges(rng):
    # Step edge + noise: bilateral must reduce noise without moving the edge.
    h, w = 64, 64
    img = np.where(np.arange(w)[None, :] < w // 2, 40.0, 70.0)
    img = np.broadcast_to(img, (h, w)).copy()
    noisy = img + rng.normal(0, 0.5, size=(h, w))
    out = np.asarray(bilateral_filter(jnp.asarray(noisy, jnp.float32),
                                      radius=1, sigma_color=10.0,
                                      sigma_space=25.0))
    # Noise reduced on the flats.
    flat = (slice(8, -8), slice(8, w // 2 - 4))
    assert np.std(out[flat] - img[flat]) < 0.7 * np.std(
        noisy[flat] - img[flat])
    # Edge magnitude preserved within 10%.
    edge_in = np.abs(noisy[:, w // 2 + 1].mean() - noisy[:, w // 2 - 2].mean())
    edge_out = np.abs(out[:, w // 2 + 1].mean() - out[:, w // 2 - 2].mean())
    assert edge_out > 0.9 * edge_in


def test_bilateral_hole_aware(rng):
    img = rng.uniform(40, 42, size=(32, 32)).astype(np.float32)
    img[10:14, 10:14] = 0.0   # holes
    out = np.asarray(bilateral_filter(jnp.asarray(img)))
    assert (out[10:14, 10:14] == 0.0).all()       # holes stay holes
    assert (out[img != 0] != 0).all()             # valid stays valid


@pytest.mark.parametrize("hole_aware", [True, False])
@pytest.mark.parametrize("shape", [(24, 40), (17, 33)])
def test_bilateral_matches_golden(rng, shape, hole_aware):
    """The XLA bilateral filter against the f64 pixel loop: holes (5%)
    stay holes and carry no weight, and neighbors outside the image are
    missing rather than wrapped or replicated."""
    z = (50.0 + rng.normal(0, 0.4, size=shape)).astype(np.float32)
    z[rng.uniform(size=shape) < 0.05] = 0.0
    got = np.asarray(bilateral_filter(jnp.asarray(z),
                                      hole_aware=hole_aware))
    want = golden.bilateral_filter(z, hole_aware=hole_aware)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if hole_aware:
        np.testing.assert_array_equal(got == 0.0, z == 0.0)


def test_bilateral_borders_do_not_wrap():
    """Column 0 must not see the far edge (the reference camera's 1280
    px width is a power-of-two multiple, where a wrapped stencil would
    mix the left and right borders), and row 0 must not see the last
    row."""
    z = np.full((16, 128), 50.0, np.float32)
    z[:, -1] = 80.0
    z[-1, :] = 80.0
    out = np.asarray(bilateral_filter(jnp.asarray(z)))
    np.testing.assert_allclose(out[:-2, 0], 50.0, atol=1e-5)
    np.testing.assert_allclose(out[0, :-2], 50.0, atol=1e-5)
