"""The reference's full-length scenario: 100 dynamic frames.

The reference tracks DYNAFRAME_MAXNUM = 100 frames (DynaFrame/
StaticParameters.cpp:31) through CCalculation::CalculateOther
(CCalculation.cpp:208-320), integrating P[f] = P[f-1] + deltaP with no
correction — the pipeline's dominant failure mode is the drift this
accumulates. These tests run the full 100-frame sequence and pin the
terminal drift for (a) exact reference semantics, (b) the improved
tracker (sub-pixel extrema + gradient-scaled deltas + robust delta
combine), and (c) the improved tracker with periodic absolute
re-anchoring, asserting the improvement ordering and absolute bounds.
"""

import numpy as np
import jax
import jax.numpy as jnp

from slc_tpu import synth
from slc_tpu.calib import synthetic_calibration, build_tables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import init_tracker, reanchor, run_sequence

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
N_FRAMES = 100
Z0, DZ = 50.0, 0.08


def _sequence():
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    # stripe_period=12 projector px ~= 21 camera px here — the stripe
    # spacing the reference's reco window (21 px) is designed around;
    # wider stripes leave most pixels without an extremum in-window.
    frames, z_gt, pu_gt = synth.render_dynamic_sequence(
        calib, CFG, N_FRAMES, z0=Z0, dz_per_frame=DZ, stripe_period=12,
        noise_sigma=1.0)
    return calib, tables, frames, z_gt, pu_gt


def _drift(z: np.ndarray, z_gt: np.ndarray) -> float:
    """Median |z - z_gt| on interior valid pixels of a frame.

    The border band (reco_window//2 px) never gets stripe offsets
    (stripe_regression zeroes it), so it is excluded as in the
    reference's own windowed scans (CCalculation.cpp:828-850).
    """
    r = CFG.reco_window // 2 + 2
    z = z[r:-r, r:-r]
    gt = z_gt[r:-r, r:-r]
    valid = z > 0
    assert valid.mean() > 0.9
    return float(np.median(np.abs(z[valid] - gt[valid])))


def _run(tables, frames, z_gt, pu_gt, scale_gradient, subpixel,
         robust=True):
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pu_gt[0], jnp.float32),
                         jnp.asarray(z_gt[0], jnp.float32),
                         CFG, subpixel=subpixel)
    state, res = run_sequence(state, jnp.asarray(frames[1:]), tables, CFG,
                              scale_gradient=scale_gradient,
                              subpixel=subpixel, robust=robust)
    return (_drift(np.asarray(res.z[-1]), z_gt[-1]),      # 100 frames
            _drift(np.asarray(res.z[7]), z_gt[8]))        # 8 frames


def test_100_frame_drift_reference_vs_improved():
    """Terminal drift after the full 100-frame sequence:

      reference semantics (integer extrema, unscaled deltas, min-|d|
      selection, CCalculation.cpp:595-660)  >>  improved tracker
      (sub-pixel parabola refinement + dP/du gradient scaling +
      robust delta combine).

    Measured behavior this pins (z units; total gt motion = 7.92):
      * 8-frame drift (the PERF.md configuration): improved ~0.008
        vs reference ~0.04+ — near-exact over short horizons.
      * 100-frame free-running drift: improved ~1.3 vs reference
        ~3.9 — BOTH accumulate stripe lock-loss over the reference's
        full scenario; that is the honest motivation for re-anchoring
        (test below), not something the estimators alone solve.
    """
    _, tables, frames, z_gt, pu_gt = _sequence()

    drift_ref, drift_ref8 = _run(tables, frames, z_gt, pu_gt,
                                 scale_gradient=False, subpixel=False,
                                 robust=False)
    drift_imp, drift_imp8 = _run(tables, frames, z_gt, pu_gt,
                                 scale_gradient=True, subpixel=True)

    # Short horizon: improved is near-exact and decisively better.
    assert drift_imp8 < 0.02, drift_imp8
    assert drift_ref8 > 2.0 * drift_imp8, (drift_ref8, drift_imp8)
    # Full 100 frames: improved still wins, and reference semantics
    # complete finite/sane (behavior reproduced, not hidden).
    assert drift_imp < 2.0, drift_imp
    assert drift_ref > 1.5 * drift_imp, (drift_ref, drift_imp)
    assert drift_ref < 6.0, drift_ref


def test_100_frame_phase_locked_tracking():
    """Phase-locked tracking (slc_tpu/ops/demod.py) over the full
    100-frame sequence with NO re-anchor groups: snapping the
    integrated P to the wrapped carrier phase embedded in every dynamic
    frame must hold terminal drift at the per-frame noise level —
    O(1) instead of the open-loop O(frames) integration the reference
    performs (CCalculation.cpp:652-660)."""
    _, tables, frames, z_gt, pu_gt = _sequence()

    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pu_gt[0], jnp.float32),
                         jnp.asarray(z_gt[0], jnp.float32),
                         CFG)
    state, res = run_sequence(state, jnp.asarray(frames[1:]), tables,
                              CFG, phase_lock=12.0, lock_win_u=21,
                              lock_win_v=9)
    drift_locked = _drift(np.asarray(res.z[-1]), z_gt[-1])
    drift_free, _ = _run(tables, frames, z_gt, pu_gt,
                         scale_gradient=True, subpixel=True)
    # VERDICT r3 item 1's bar: < 0.1 scene units after 100 frames.
    assert drift_locked < 0.1, drift_locked
    assert drift_locked < 0.1 * drift_free, (drift_locked, drift_free)
    # Terminal ~= early drift: error is not integrating.
    drift_locked_8 = _drift(np.asarray(res.z[7]), z_gt[8])
    assert drift_locked < 5.0 * max(drift_locked_8, 0.005), \
        (drift_locked, drift_locked_8)


def test_100_frame_reanchoring_bounds_drift():
    """Periodic absolute re-anchoring (every 25 frames) must bound the
    terminal drift well below the free-running improved tracker on the
    same sequence — drift resets at each anchor instead of integrating
    over all 100 frames."""
    calib, tables, frames, z_gt, pu_gt = _sequence()

    from slc_tpu.pipeline import decode_first_frame

    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pu_gt[0], jnp.float32),
                         jnp.asarray(z_gt[0], jnp.float32),
                         CFG)
    frames_j = jnp.asarray(frames)
    anchor_every = 25
    res_z_last = None
    f = 1
    while f < N_FRAMES:
        end = min(f + anchor_every - 1, N_FRAMES)
        state, res = run_sequence(state, frames_j[f:end], tables, CFG)
        res_z_last = np.asarray(res.z[-1])
        f = end
        if f < N_FRAMES:
            # Fresh absolute decode at the anchor frame (a full pattern
            # group projected mid-sequence), then resume tracking.
            asc = synth.render_static_scene(
                calib, CFG, synth.plane_surface(Z0 + DZ * f),
                noise_sigma=1.0, seed=f)
            dec = decode_first_frame(jnp.asarray(asc.gray_images),
                                     jnp.asarray(asc.phase_images),
                                     tables, CFG)
            state = reanchor(state, frames_j[f], dec.proj_u, dec.z,
                             CFG)
            f += 1

    drift_anchored = _drift(res_z_last, z_gt[-1])
    drift_free, _ = _run(tables, frames, z_gt, pu_gt,
                         scale_gradient=True, subpixel=True)
    assert drift_anchored < 0.5 * drift_free, (drift_anchored, drift_free)
    assert drift_anchored < 0.25, drift_anchored
