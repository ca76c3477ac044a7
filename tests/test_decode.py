"""Unit tests: phase decode, Gray decode, unwrap merge, heterodyne."""

import numpy as np
import jax.numpy as jnp
import pytest

from slc_tpu import patterns
from slc_tpu import golden
from slc_tpu.ops.gray import (decode_gray, gray_to_binary, binary_to_gray,
                              decode_gray_bins)
from slc_tpu.ops.phase import decode_phase, modulation
from slc_tpu.ops.unwrap import gray_assisted_merge, heterodyne_unwrap


# ----------------------------------------------------------------- phase

def test_phase_decode_4step_matches_reference_formula(rng):
    """For N=4 the generalized estimator must equal the reference's
    (I0-I2)/2, (I1-I3)/2 (CDecodePhase.cpp:64-65) convention."""
    imgs = rng.integers(0, 256, size=(4, 16, 32), dtype=np.uint8)
    ours = np.asarray(decode_phase(jnp.asarray(imgs), 40.0))
    theirs = golden.decode_phase(imgs, 40.0)
    np.testing.assert_allclose(ours, theirs, atol=2e-4)


def test_phase_decode_recovers_coordinate():
    """decode(I(x)) == x mod T for the pattern model of slc_tpu.patterns."""
    t = 40.0
    x = np.linspace(0.3, 600.0, 997)
    imgs = np.stack([patterns.fringe_at(x, k, 4, t) for k in range(4)])
    pix = np.asarray(decode_phase(jnp.asarray(imgs[:, None, :]), t))[0]
    want = np.mod(x, t)
    # pix == T is congruent to 0.
    got = np.where(pix > t - 1e-3, pix - t, pix)
    want = np.where(want > t - 1e-3, want - t, want)
    err = np.abs(got - want)
    err = np.minimum(err, t - err)
    assert err.max() < 1e-3


def test_phase_decode_8step():
    t = 64.0
    x = np.linspace(0.0, 500.0, 509)
    imgs = np.stack([patterns.fringe_at(x, k, 8, t) for k in range(8)])
    pix = np.asarray(decode_phase(jnp.asarray(imgs[:, None, :]), t))[0]
    err = np.abs(np.mod(pix, t) - np.mod(x, t))
    err = np.minimum(err, t - err)
    assert err.max() < 1e-3


def test_modulation_flags_fringeless_pixels():
    t = 32.0
    x = np.linspace(0, 100, 64)
    imgs = np.stack([patterns.fringe_at(x, k, 4, t) for k in range(4)])
    imgs[:, 10:20] = 7.0  # flat region: no fringe signal
    m = np.asarray(modulation(jnp.asarray(imgs[:, None, :])))[0]
    assert (m[10:20] < 1.0).all()
    good = np.ones(64, bool)
    good[10:20] = False
    assert (m[good] > 100.0).all()


# ------------------------------------------------------------------ gray

# The reference's shipped LUT (Patterns/vGrayCode.txt:1-64), pinned as
# literal data so this test constrains the code rather than re-deriving
# the table from the same b^(b>>1) formula it is meant to validate.
_REFERENCE_GRAY_LUT = [
    (0, 0), (1, 1), (2, 3), (3, 2), (4, 6), (5, 7), (6, 5), (7, 4),
    (8, 12), (9, 13), (10, 15), (11, 14), (12, 10), (13, 11), (14, 9),
    (15, 8), (16, 24), (17, 25), (18, 27), (19, 26), (20, 30), (21, 31),
    (22, 29), (23, 28), (24, 20), (25, 21), (26, 23), (27, 22), (28, 18),
    (29, 19), (30, 17), (31, 16), (32, 48), (33, 49), (34, 51), (35, 50),
    (36, 54), (37, 55), (38, 53), (39, 52), (40, 60), (41, 61), (42, 63),
    (43, 62), (44, 58), (45, 59), (46, 57), (47, 56), (48, 40), (49, 41),
    (50, 43), (51, 42), (52, 46), (53, 47), (54, 45), (55, 44), (56, 36),
    (57, 37), (58, 39), (59, 38), (60, 34), (61, 35), (62, 33), (63, 32),
]


def test_gray_xor_prefix_matches_reference_lut():
    """The XOR-prefix inverse and the table generator must reproduce
    the reference's shipped LUT (Patterns/vGrayCode.txt:1-64) exactly,
    pinned above as the 64 literal (bin, gray) rows."""
    assert len(_REFERENCE_GRAY_LUT) == 64
    np.testing.assert_array_equal(patterns.gray_lut_table(6),
                                  np.asarray(_REFERENCE_GRAY_LUT))
    for b, g in _REFERENCE_GRAY_LUT:
        assert int(binary_to_gray(jnp.int32(b))) == g
        assert int(gray_to_binary(jnp.int32(g), 6)) == b


def test_gray_decode_synthetic_bins():
    cfg_bits, pro_w = 6, 1280
    period = pro_w / (1 << cfg_bits)
    imgs = patterns.gray_pattern_images(pro_w, 4, cfg_bits)  # 12 x 4 x 1280
    out = np.asarray(decode_gray(jnp.asarray(imgs), cfg_bits, pro_w))
    x = np.arange(pro_w)
    want = (x // period).astype(np.float64) * period
    np.testing.assert_array_equal(out[0], want)


def test_gray_decode_matches_golden(rng):
    imgs = rng.integers(0, 256, size=(10, 8, 16), dtype=np.uint8)
    ours = np.asarray(decode_gray(jnp.asarray(imgs), 5, 640))
    theirs = golden.decode_gray(imgs, 5, 640)
    np.testing.assert_array_equal(ours, theirs)


def test_gray_bins_roundtrip(rng):
    bins = rng.integers(0, 64, size=(6, 9))
    gray = np.asarray(binary_to_gray(jnp.asarray(bins)))
    imgs = np.zeros((12, 6, 9), np.uint8)
    for k in range(6):
        bit = ((gray >> k) & 1).astype(np.uint8)
        imgs[2 * k] = bit * 255
        imgs[2 * k + 1] = 255 - imgs[2 * k]
    got = np.asarray(decode_gray_bins(jnp.asarray(imgs), 6))
    np.testing.assert_array_equal(got, bins)


# ---------------------------------------------------------------- unwrap

def test_gray_assisted_merge_recovers_absolute_coordinate():
    """End-to-end gray+phase on a continuous coordinate ramp: merged P
    must equal x to sub-pixel accuracy everywhere, including bin
    boundaries (CCalculation.cpp:561-587 semantics)."""
    bits, pro_w = 6, 1280
    gp = pro_w / (1 << bits)          # 20
    t = 2 * gp                        # 40
    x = np.linspace(1.0, pro_w - 2.0, 4001)

    gray_imgs = np.stack([
        v for k in range(bits)
        for v in (patterns.gray_bit_at(x, k, gp) * np.uint8(255),
                  255 - patterns.gray_bit_at(x, k, gp) * np.uint8(255))])
    phase_imgs = np.stack(
        [patterns.fringe_at(x, k, 4, t) for k in range(4)])

    g = decode_gray(jnp.asarray(gray_imgs[:, None, :]), bits, pro_w)
    p = decode_phase(jnp.asarray(phase_imgs[:, None, :]), t)
    merged = np.asarray(gray_assisted_merge(g, p, gp, t))[0]
    np.testing.assert_allclose(merged, x, atol=1e-3)


def test_gray_assisted_merge_matches_golden(rng):
    gray = rng.integers(0, 64, size=(32, 48)).astype(np.float64) * 20.0
    phase = rng.uniform(0.0, 40.0, size=(32, 48))
    ours = np.asarray(gray_assisted_merge(
        jnp.asarray(gray, jnp.float32), jnp.asarray(phase, jnp.float32),
        20.0, 40.0))
    theirs = golden.gray_assisted_merge(gray, phase, 20.0, 40.0)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)


def test_heterodyne_unwrap_exact():
    pro_w = 640
    periods = (640.0 / 64, 640.0 / 59, 640.0 / 55)   # cascade reaches 640
    x = np.linspace(0.5, pro_w - 1.5, 3001)
    wrapped = np.stack([np.mod(x, p) for p in periods]).astype(np.float32)
    got = np.asarray(heterodyne_unwrap(
        jnp.asarray(wrapped[:, None, :]), periods, float(pro_w)))[0]
    np.testing.assert_allclose(got, x, atol=2e-3)


def test_heterodyne_unwrap_noise_robust(rng):
    pro_w = 640
    periods = (10.0, 640.0 / 59, 640.0 / 55)
    x = rng.uniform(1.0, pro_w - 1.0, size=(64, 128))
    noise = rng.normal(0.0, 0.02, size=(3,) + x.shape)
    wrapped = np.stack(
        [np.mod(x + noise[i], p) for i, p in enumerate(periods)]
    ).astype(np.float32)
    got = np.asarray(heterodyne_unwrap(
        jnp.asarray(wrapped), periods, float(pro_w)))
    # Final re-anchoring is to the finest frequency: error == finest noise.
    assert np.abs(got - x).max() < 0.1


# ------------------------------------------------- full decodes vs f64

def _order_flips(got, want, period, atol):
    """Pixels where the f32 path and the f64 oracle disagree by more
    than ``atol`` must be whole fringe-order flips (|d| == period) at
    rounding boundaries: isolated (no 2x2 block), returned as a mask."""
    d = np.asarray(got, np.float64) - want
    flip = np.abs(d) > atol
    if flip.any():
        np.testing.assert_allclose(np.abs(d[flip]), period, atol=1e-2)
        blk = flip[:-1, :-1] & flip[1:, :-1] & flip[:-1, 1:] & flip[1:, 1:]
        assert not blk.any(), "coherent block of order flips"
    return flip


@pytest.mark.parametrize("min_mod", [None, 2.0])
def test_grayphase_decode_matches_golden(min_mod):
    """Frame-0 Gray+phase decode + triangulation (decode_first_frame) on
    a rendered sphere against the f64 oracle chain decode_gray ->
    decode_phase -> gray_assisted_merge -> triangulate, with and without
    the modulation mask."""
    from slc_tpu import synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import TEST_CONFIG as cfg
    from slc_tpu.pipeline import decode_first_frame

    calib = synthetic_calibration()
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
    scene = synth.render_static_scene(calib, cfg, synth.sphere_surface(),
                                      noise_sigma=1.0)
    res = decode_first_frame(jnp.asarray(scene.gray_images),
                             jnp.asarray(scene.phase_images), tables, cfg,
                             min_modulation=min_mod)
    pu = golden.gray_assisted_merge(
        golden.decode_gray(scene.gray_images, cfg.gray_bits, cfg.pro_w),
        golden.decode_phase(scene.phase_images, cfg.phase_period),
        cfg.gray_period, cfg.phase_period)
    if min_mod is not None:
        pu = np.where(golden.modulation(scene.phase_images) > min_mod,
                      pu, 0.0)
    flip = _order_flips(res.proj_u, pu, cfg.phase_period, 1e-3)
    assert flip.sum() <= 4
    _, _, z = golden.triangulate(pu, np.asarray(calib.cam_k, np.float64),
                                 calib.pro_mat(), cfg.fov_min, cfg.fov_max)
    np.testing.assert_allclose(np.asarray(res.z)[~flip], z[~flip],
                               atol=5e-3)


@pytest.mark.parametrize("min_mod", [None, 2.0])
def test_heterodyne_decode_matches_golden(min_mod):
    """decode_heterodyne_frame on a rendered sphere against the f64
    per-period decode -> beat cascade -> triangulate chain."""
    from slc_tpu import synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import TEST_CONFIG as cfg, HeterodyneConfig
    from slc_tpu.pipeline import decode_heterodyne_frame

    het = HeterodyneConfig()
    periods = het.periods(cfg.pro_w)
    calib = synthetic_calibration()
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
    imgs, _, _ = synth.render_fringe_stack(
        calib, cfg, synth.sphere_surface(), periods, het.phase_steps,
        noise_sigma=1.0)
    res = decode_heterodyne_frame(jnp.asarray(imgs), tables, cfg, het,
                                  min_modulation=min_mod)
    n = het.phase_steps
    stacks = [imgs[i * n:(i + 1) * n] for i in range(len(periods))]
    # decode_phase's (0, T] convention: T is congruent to 0.
    wrapped = [np.mod(golden.decode_phase(s, p), p)
               for s, p in zip(stacks, periods)]
    pu = golden.heterodyne_unwrap(wrapped, periods, float(cfg.pro_w))
    if min_mod is not None:
        mod = np.min([golden.modulation(s) for s in stacks], axis=0)
        pu = np.where(mod > min_mod, pu, 0.0)
    flip = _order_flips(res.proj_u, pu, periods[0], 1e-2)
    assert flip.sum() <= 8
    _, _, z = golden.triangulate(pu, np.asarray(calib.cam_k, np.float64),
                                 calib.pro_mat(), cfg.fov_min, cfg.fov_max)
    np.testing.assert_allclose(np.asarray(res.z)[~flip], z[~flip],
                               atol=5e-3)


@pytest.mark.parametrize("steps", [1, 2])
def test_phase_decode_rejects_degenerate_steps(steps):
    """Fewer than 3 phase steps cannot separate sin from cos; the
    decoders refuse at trace time instead of returning garbage."""
    with pytest.raises(ValueError, match="n_steps"):
        decode_phase(jnp.zeros((steps, 8, 16), jnp.uint8), 40.0)
