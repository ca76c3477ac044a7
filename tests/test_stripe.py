"""Stripe tracker: exact parity with the golden scalar transcription of
CCalculation::StripRegression (CCalculation.cpp:789-891), including the
strict-inequality tie-breaking and border behavior."""

import numpy as np
import jax.numpy as jnp
import pytest

from slc_tpu import golden
from slc_tpu.ops.stripe import (box_sum_vertical, windowed_extrema,
                                stripe_regression, select_delta_p)
from slc_tpu.ops.filters import box_blur_3x3


@pytest.mark.parametrize("window", [7, 21])
def test_box_sum_matches_golden(rng, window):
    frame = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    ours = np.asarray(box_sum_vertical(jnp.asarray(frame), window))
    theirs = golden.box_sum_vertical(frame, window)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("window", [7, 21])
def test_windowed_extrema_matches_golden(rng, window):
    # Integer-valued sums make ties common — the hard case for parity.
    vs = rng.integers(0, 6, size=(40, 56)).astype(np.float32)
    r = window // 2
    mask = np.zeros_like(vs)
    mask[r:-r, r:-r] = 1
    vs = vs * mask
    sw, sb = windowed_extrema(jnp.asarray(vs), window)
    gw, gb = golden.windowed_extrema(vs.astype(np.float64), window)
    np.testing.assert_array_equal(np.asarray(sw), gw)
    np.testing.assert_array_equal(np.asarray(sb), gb)


def test_stripe_regression_full_parity(rng):
    frame = rng.integers(0, 256, size=(64, 96), dtype=np.uint8)
    window = 21
    sw, sb = stripe_regression(jnp.asarray(frame), window)
    vs = golden.box_sum_vertical(frame, window)
    gw, gb = golden.windowed_extrema(vs, window)
    np.testing.assert_array_equal(np.asarray(sw), gw)
    np.testing.assert_array_equal(np.asarray(sb), gb)


def test_stripe_tracks_known_shift():
    """A sinusoidal stripe image shifted by s columns must shift the
    detected extremum offsets by s within the valid interior.

    For any given pixel, ONE of the two stripe families (bright/dark,
    10 px apart at period 20) may cross the search-window edge and jump
    by a period — the min(|dW|, |dB|) selection (CCalculation.cpp:603-618)
    must always pick the family that tracked the true shift."""
    h, w, window = 64, 128, 21
    from slc_tpu import patterns
    f0 = patterns.stripe_pattern(w, h, period=20)
    s = 3
    f1 = np.roll(f0, s, axis=1)
    w0, b0 = stripe_regression(jnp.asarray(f0), window)
    w1, b1 = stripe_regression(jnp.asarray(f1), window)
    dp = np.asarray(select_delta_p(w0, b0, w1, b1))
    # Interior, away from image-border effects.
    inner = dp[window:-window, window:-window]
    assert np.abs(inner + s).max() < 1e-6  # deltaP = prev - cur = -s


def test_dynamic_step_matches_golden(rng):
    """Full dynamic-frame update (track -> select -> blur -> integrate,
    CCalculation.cpp:595-663) against the golden implementation."""
    h, w, window = 48, 64, 7
    f0 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    f1 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    pu0 = rng.uniform(100.0, 500.0, size=(h, w))

    sw0, sb0 = stripe_regression(jnp.asarray(f0), window)
    sw1, sb1 = stripe_regression(jnp.asarray(f1), window)
    dp = box_blur_3x3(select_delta_p(sw0, sb0, sw1, sb1))
    pu1 = np.asarray(jnp.asarray(pu0, jnp.float32) + dp)

    gw0, gb0 = golden.windowed_extrema(
        golden.box_sum_vertical(f0, window), window)
    g_pu1, _, _, _ = golden.dynamic_step(pu0, gw0, gb0, f1, window)
    np.testing.assert_allclose(pu1, g_pu1, atol=1e-3)


def _windowed_extrema_loop(vs, window):
    """The reference's scan (CCalculation.cpp:828-891) pixel by pixel, as
    the oracle once wrote it: the check on golden's vectorized form."""
    r = window // 2
    h, w = vs.shape
    sw, sb = np.zeros((h, w)), np.zeros((h, w))
    for row in range(r, h - r):
        for col in range(r, w - r):
            vmax = vmin = vs[row, col]
            imax = imin = 0.0
            for i in range(-r, r):
                val = vs[row, col + i]
                if val > vmax:
                    vmax, imax = val, float(i)
                if val < vmin:
                    vmin, imin = val, float(i)
            sw[row, col], sb[row, col] = imax, imin
    return sw, sb


@pytest.mark.parametrize("window", [5, 8, 21])
def test_golden_extrema_equal_the_literal_scan(rng, window):
    vs = rng.integers(0, 6, size=(30, 47)).astype(np.float64)
    gw, gb = golden.windowed_extrema(vs, window)
    lw, lb = _windowed_extrema_loop(vs, window)
    np.testing.assert_array_equal(gw, lw)
    np.testing.assert_array_equal(gb, lb)


@pytest.mark.parametrize("width", [96, 101])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("window", [5, 8, 21])
def test_stripe_regression_matches_golden(rng, window, subpixel, width):
    """The XLA stripe tracker against the f64 oracle for odd, even and
    the reference's window, with and without the sub-pixel parabola, on
    even and odd image widths. Box sums of uint8 are exact in f32, so
    the winning offsets agree exactly; the parabola fraction to f32
    rounding."""
    frame = rng.integers(0, 256, size=(64, width), dtype=np.uint8)
    sw, sb = stripe_regression(jnp.asarray(frame), window, subpixel)
    gw, gb = golden.windowed_extrema(
        golden.box_sum_vertical(frame, window), window, subpixel)
    np.testing.assert_allclose(np.asarray(sw), gw, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sb), gb, atol=1e-5)
    if not subpixel:
        np.testing.assert_array_equal(np.asarray(sw), gw)
        np.testing.assert_array_equal(np.asarray(sb), gb)


@pytest.mark.parametrize("shape", [(96, 160), (90, 151)])
def test_open_loop_step_matches_golden(rng, shape):
    """dynamic_step with reference semantics (integer offsets, no
    gradient scaling, min-|d| pick) against golden.dynamic_step, then
    triangulated against the f64 triangulation: the whole open-loop
    frame of CCalculation.cpp:595-663 + :666-785."""
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import SystemConfig
    from slc_tpu.dynamic import TrackerState, dynamic_step

    h, w = shape
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=640, gray_bits=5)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=h, pro_w=640)
    tables = build_tables(calib, h, w)
    window = cfg.reco_window
    f0 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    f1 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    pu0 = rng.uniform(200.0, 440.0, size=(h, w)).astype(np.float32)
    gw0, gb0 = golden.windowed_extrema(
        golden.box_sum_vertical(f0, window), window)

    st = TrackerState(proj_u=jnp.asarray(pu0),
                      strip_w=jnp.asarray(gw0, jnp.float32),
                      strip_b=jnp.asarray(gb0, jnp.float32),
                      z=jnp.zeros((h, w), jnp.float32),
                      frame_idx=jnp.int32(0))
    st1, res = dynamic_step(st, jnp.asarray(f1), tables, cfg,
                            scale_gradient=False, subpixel=False,
                            robust=False)
    g_pu, g_sw, g_sb, _ = golden.dynamic_step(
        pu0.astype(np.float64), gw0, gb0, f1, window)
    np.testing.assert_array_equal(np.asarray(st1.strip_w), g_sw)
    np.testing.assert_array_equal(np.asarray(st1.strip_b), g_sb)
    np.testing.assert_allclose(np.asarray(res.proj_u), g_pu, atol=1e-3)
    _, _, g_z = golden.triangulate(g_pu, np.asarray(calib.cam_k, np.float64),
                                   calib.pro_mat(), cfg.fov_min, cfg.fov_max)
    np.testing.assert_allclose(np.asarray(res.z), g_z, atol=5e-3)
