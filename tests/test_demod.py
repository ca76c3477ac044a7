"""Phase-locked tracking: single-frame stripe-phase demodulation.

The dynamic stripe pattern is an absolute-mod-T phase carrier present in
every cFrame image; the reference ignores it and integrates stripe
motion open loop (CCalculation.cpp:652-660). These tests validate the
lock-in demodulator (slc_tpu/ops/demod.py) open-loop, closed-loop on a
discontinuous scene, and its interaction with the hole semantics.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from slc_tpu import synth
from slc_tpu.calib import synthetic_calibration, build_tables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import init_tracker, run_sequence
from slc_tpu.ops.demod import (stripe_phase_correction,
                               suggest_lock_window)

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
T = 12  # stripe period, projector px (~21 camera px at this rig)


@pytest.fixture(scope="module")
def scene():
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, z_gt, pu_gt = synth.render_dynamic_sequence(
        calib, CFG, 3, z0=50.0, dz_per_frame=0.08, stripe_period=T,
        noise_sigma=1.0)
    return calib, tables, frames, z_gt, pu_gt


def test_lock_window_suggestion(scene):
    _, _, _, _, pu_gt = scene
    win = suggest_lock_window(pu_gt[0], float(T))
    # Carrier ~21 camera px at this rig (median dP/du ~ 0.57).
    assert 15 <= win <= 27, win


def test_exact_prediction_near_zero_correction(scene):
    """With the true map as prediction the correction must be phase
    noise only (<< 1 projector px), and the demodulated amplitude must
    match the pattern's A/2 = 63.5."""
    _, _, frames, _, pu_gt = scene
    dp, amp = stripe_phase_correction(
        jnp.asarray(frames[1]), jnp.asarray(pu_gt[1], jnp.float32),
        float(T), 21, 9)
    r = 12
    dp_i = np.asarray(dp)[r:-r, r:-r]
    amp_i = np.asarray(amp)[r:-r, r:-r]
    assert np.median(np.abs(dp_i)) < 0.05
    assert np.percentile(np.abs(dp_i), 95) < 0.2
    assert abs(np.median(amp_i) - 63.5) < 3.0


@pytest.mark.parametrize("bias", [-2.5, 1.5, 4.0])
def test_bias_recovery_within_half_period(scene, bias):
    """A constant prediction bias < T/2 must be measured back almost
    exactly — the property that converts O(f) drift into O(1) error."""
    _, _, frames, _, pu_gt = scene
    pred = jnp.asarray(pu_gt[1] + bias, jnp.float32)
    dp, _ = stripe_phase_correction(jnp.asarray(frames[1]), pred,
                                    float(T), 21, 9)
    r = 12
    dp_i = np.asarray(dp)[r:-r, r:-r]
    assert abs(np.median(dp_i) + bias) < 0.05, (np.median(dp_i), bias)


def test_holes_and_low_amplitude_gated(scene):
    """Hole pixels (P==0) and non-fringe images get zero correction."""
    _, _, frames, _, pu_gt = scene
    pred = np.asarray(pu_gt[1], np.float32)
    pred[:, 40:60] = 0.0                      # hole band
    dp, _ = stripe_phase_correction(jnp.asarray(frames[1]),
                                    jnp.asarray(pred), float(T), 21, 9)
    assert np.all(np.asarray(dp)[:, 40:60] == 0.0)
    # A flat (carrier-free) image gates everything via the amp floor.
    flat = jnp.full(frames[1].shape, 127, jnp.uint8)
    dp2, amp2 = stripe_phase_correction(flat, jnp.asarray(pu_gt[1],
                                                          jnp.float32),
                                        float(T), 21, 9)
    assert np.all(np.asarray(dp2) == 0.0)
    assert np.median(np.asarray(amp2)) < 8.0


def test_phase_locked_tracking_discontinuous_scene():
    """Closed-loop parity on a scene with a multi-fringe-order depth
    step: the phase-locked tracker must stay accurate on BOTH sides of
    the discontinuity (away from the demod window straddling the edge)
    while the free-running tracker accumulates drift."""
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    n = 40
    dz = 0.08

    def surf(f):
        return synth.step_surface(48.0 + dz * f, 58.0 + dz * f)

    frames, z_gt, pu_gt = synth.render_dynamic_sequence(
        calib, CFG, n, stripe_period=T, noise_sigma=1.0,
        surface_for_frame=surf)

    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pu_gt[0], jnp.float32),
                         jnp.asarray(z_gt[0], jnp.float32),
                         CFG)
    state, res = run_sequence(state, jnp.asarray(frames[1:]), tables,
                              CFG, phase_lock=float(T), lock_win_u=21,
                              lock_win_v=9)
    z = np.asarray(res.z[-1])
    gt = z_gt[-1]
    # The step edge sits at camera col ~cx; exclude the demod support
    # (2*21-1 px) plus the tracker border band around it and the frame.
    edge = int(np.asarray(calib.cam_k)[0, 2])
    r = CFG.reco_window // 2 + 2
    guard = 22
    err = np.abs(z - gt)
    for sl in (np.s_[r:-r, r:edge - guard],
               np.s_[r:-r, edge + guard:-r]):
        side = err[sl]
        valid = z[sl] > 0
        assert valid.mean() > 0.9
        med = float(np.median(side[valid]))
        assert med < 0.1, med


@pytest.mark.parametrize("h", [90, 100])
def test_locked_step_partial_last_gate_band(h):
    """Image heights that leave a partial last GATE_BAND (26 and 36 rows
    here): a carrier-gradient error confined to that band must gate the
    band's correction off — so the locked step equals the open-loop
    step there — while the full band above stays locked."""
    from slc_tpu.dynamic import TrackerState, dynamic_step
    from slc_tpu.ops.demod import GATE_BAND

    cfg = SystemConfig(cam_h=h, cam_w=160, pro_h=96, pro_w=640,
                       gray_bits=5)
    calib = synthetic_calibration(cam_h=h, cam_w=160, pro_h=96, pro_w=640)
    tables = build_tables(calib, h, 160)
    frames, z_gt, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, z0=50.0, dz_per_frame=0.08, stripe_period=T,
        noise_sigma=1.0)
    tail = np.arange(h) >= GATE_BAND
    # 0.02 px/px ramp -> 2*pi/T * 0.02 ~ 10 mrad/px of carrier gradient,
    # 5x the gate's 2 mrad/px; a constant bias above it passes the gate.
    ramp = 0.02 * np.arange(160)[None, :] * tail[:, None]
    pred = (pu_gt[1] + 1.3 + ramp).astype(np.float32)

    dp, _ = stripe_phase_correction(jnp.asarray(frames[1]),
                                    jnp.asarray(pred), float(T), 21, 9)
    dp = np.asarray(dp)
    assert np.all(dp[tail] == 0.0)
    top = dp[12:GATE_BAND - 12, 12:-12]
    assert np.median(np.abs(top + 1.3)) < 0.2     # locked to the truth

    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pu_gt[0] + ramp, jnp.float32),
                         jnp.asarray(z_gt[0], jnp.float32), cfg)
    copy = lambda s: TrackerState(*(jnp.array(a) for a in (
        s.proj_u, s.strip_w, s.strip_b, s.z, s.frame_idx)))
    _, opn = dynamic_step(copy(state), jnp.asarray(frames[1]), tables,
                          cfg)
    _, lck = dynamic_step(copy(state), jnp.asarray(frames[1]), tables,
                          cfg, phase_lock=float(T), lock_win_u=21,
                          lock_win_v=9)
    np.testing.assert_array_equal(np.asarray(lck.proj_u)[tail],
                                  np.asarray(opn.proj_u)[tail])
    assert np.any(np.asarray(lck.proj_u)[~tail]
                  != np.asarray(opn.proj_u)[~tail])
