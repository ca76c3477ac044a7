"""Single-frame stripe-phase demodulation (phase-locked tracking).

Every dynamic frame is lit by the sinusoidal stripe pattern
I(u, v) = A cos(2*pi*P(u, v)/T) + A  (slc_tpu.patterns.stripe_at; the
cFrame image the reference tracks extrema of, CCalculation.cpp:789-795).
The wrapped phase of that carrier is an *absolute-mod-T* measurement of
the projector map present in every single frame — a signal the
reference throws away: its dynamic loop integrates stripe motion open
loop, P[f] = P[f-1] + deltaP (CCalculation.cpp:652-660), so error
accumulates O(frames).

This module recovers that signal by synchronous (lock-in) demodulation
against the *predicted* carrier: with phi_pred = 2*pi*P_pred/T and
I_ac = I - <I> (local mean removed),

    C = < I_ac * cos(phi_pred) >  ~=  (A/2) cos(delta)
    S = < I_ac * sin(phi_pred) >  ~=  (A/2) sin(-delta)

where delta = phi_true - phi_pred and <.> is a small box low-pass that
rejects the 2*phi image term. Then delta = atan2(-S, C) and

    P = P_pred + delta * T / (2*pi)

snaps the integrated map to phase congruence each frame. The tracker
only has to predict P to within T/2; absolute accuracy comes from the
per-frame measurement, converting O(f) drift into O(1) phase noise.
The reference has no equivalent (it cannot: this requires knowing the
analytic pattern model, which it treats as opaque captured images).

The low-pass is a separable TRIANGLE kernel (box convolved with box).
This is a closed-loop stability requirement, not a taste choice: each
frame updates the prediction-error field e by e' = (I - K) e where K is
the low-pass. A plain box kernel's frequency response (sinc) goes
negative (to ~-0.217), so (I - box) has spectral radius ~1.22 and modes
near the box's negative sidelobe grow 22% per frame — measured as
divergence over the 100-frame sequence. The triangle's response is
sinc^2 in [0, 1], so (I - K) is a contraction on low frequencies and
never amplifies: low-frequency error (drift) is killed, high-frequency
error is left to the (bounded, blurred) delta-P estimator.

All ops are elementwise + separable box sums — XLA fuses them into the
step; no gathers, no data-dependent shapes.

Negative result, round 5 (do not retry): replacing the DC estimate's
triangle with a single box (it sits outside the feedback loop, so
stability does not forbid it) was measured to LEAK carrier into the DC
estimate whenever the local carrier period deviates from the box span
(the box's null is exact only at one period; the triangle's sinc^2
suppresses the whole neighborhood). The leakage distorts the
demodulated-offset gradient statistics enough to break the
carrier-consistency gate's margins (a 5% period mismatch slipped the
gate and corrupted tracking to ~2 scene units) and to halve
estimate_period's accuracy. Both filters stay triangles.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


#: Row-band height of the carrier-consistency gate, an algorithm
#: parameter: the gate averages the carrier gradient over bands of this
#: many rows and zeroes the correction band by band (a partial last band
#: is averaged over the rows it has).
GATE_BAND = 64


def _box_sum_1d(x: jax.Array, win: int, axis: int) -> jax.Array:
    """Centered ``win``-tap box sum along ``axis``, zero-padded."""
    r = win // 2
    rr = win - 1 - r
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, rr)
    xp = jnp.pad(x, pad)
    s = jnp.cumsum(xp, axis=axis)
    zshape = list(x.shape)
    zshape[axis] = 1
    s = jnp.concatenate([jnp.zeros(zshape, x.dtype), s], axis=axis)
    lo = jax.lax.slice_in_dim(s, 0, x.shape[axis], axis=axis)
    hi = jax.lax.slice_in_dim(s, win, win + x.shape[axis], axis=axis)
    return hi - lo


def _tri_sum(x: jax.Array, win_v: int, win_u: int) -> jax.Array:
    """Separable triangle-kernel sum: box(win) applied twice per axis.
    Full support 2*win - 1; frequency response sinc^2 >= 0 (see module
    docstring for why non-negativity is load-bearing)."""
    x = _box_sum_1d(_box_sum_1d(x, win_u, 1), win_u, 1)
    return _box_sum_1d(_box_sum_1d(x, win_v, 0), win_v, 0)


def _tri_weight(h: int, w: int, win_v: int, win_u: int) -> jax.Array:
    """Per-pixel total in-image kernel weight of the zero-padded
    triangle window (exact border normalization)."""
    ones_r = jnp.ones((1, w), jnp.float32)
    ones_c = jnp.ones((h, 1), jnp.float32)
    wu = _box_sum_1d(_box_sum_1d(ones_r, win_u, 1), win_u, 1)
    wv = _box_sum_1d(_box_sum_1d(ones_c, win_v, 0), win_v, 0)
    return wv * wu


@functools.partial(jax.jit, static_argnames=("period", "win_u", "win_v",
                                             "amp_floor", "per_pixel",
                                             "max_carrier_gradient"))
def stripe_phase_correction(frame: jax.Array, proj_u_pred: jax.Array,
                            period: float, win_u: int = 9,
                            win_v: int = 9, amp_floor: float = 8.0,
                            per_pixel: bool = True,
                            max_carrier_gradient: float = 2e-3
                            ) -> Tuple[jax.Array, jax.Array]:
    """Lock-in demodulation of one dynamic stripe frame against the
    predicted projector map.

    Args:
      frame: (H, W) uint8/float camera image of the stripe pattern.
      proj_u_pred: (H, W) float32 predicted absolute projector map
        (the tracker's integrated P; must be within T/2 of truth for
        the correction to snap to the right fringe order).
      period: stripe period T in projector px (the pattern model's
        ``stripe_period``).
      win_u / win_v: low-pass extents in camera px — each axis uses a
        triangle kernel of full support ``2*win - 1``. ``win_u``
        should span >= ~1 carrier period in *camera* pixels
        (~T / (dP/du)); see :func:`suggest_lock_window`.
      amp_floor: demodulated-amplitude gate in gray levels. The ideal
        full-contrast carrier demodulates to A/2 = 63.5; pixels below
        the floor (shadow, defocus, window straddling a depth edge)
        get zero correction.
      max_carrier_gradient: carrier-consistency gate (rad per camera
        px). A mis-specified lock period T leaves a near-CONSTANT
        spatial gradient in the demodulated offset delta_phi —
        g = 2*pi*(dP/du)*(1/T_lock - 1/T_true), ~3 mrad/px per 1% of
        mismatch on the synthetic rig — where in the LOCKED loop the
        genuine tracking-error gradient stays at the single-frame
        motion level (~1 mrad/px at 0.3 z-units/frame, the lock resets
        drift every frame; static scenes ~0). Free-running drift can
        accumulate to ~3 mrad/px, which is why the gate keys on the
        locked loop's own prediction.
        When a GATE_BAND-row band's amplitude-gated mean |g| exceeds
        this threshold that band's correction is zeroed: the
        tracker falls back to open-loop integration there instead of
        absorbing a systematically wrong snap (the failure mode measured before
        this gate: +-2-5% period error drove median z error to ~2
        scene units within 15 frames, 30x worse than free-running).
        FAILURE ENVELOPE (threshold 2 mrad/px): mismatches >= ~2%
        gate off on every tested scene regardless of motion direction
        (graceful fallback to open-loop); ~1-2% is scene-dependent
        (the motion-error gradient can partially cancel the mismatch
        gradient); < ~0.7% passes, contributing bias bounded by
        thresh*T/(2*pi) (~4e-3 projector px per frame). If the lock
        period is only known to worse than ~1%, calibrate it first
        (one absolute decode gives dP/du and the carrier frequency
        directly). Set 0 or inf to disable.
      per_pixel: additionally refine each pixel with its own absolute
        phase reading: cos(phi) = (I - DC)/A with DC and A taken from
        the smooth windowed estimates, phi = +-arccos resolved (sign
        AND fringe order) against the window-corrected prediction,
        blended by a sin^2(phi) confidence (arccos is ill-conditioned
        at the fringe extrema). This makes P a per-frame *measurement*
        at every well-conditioned pixel — error does not integrate at
        any spatial frequency, where the windowed term alone only
        suppresses frequencies inside the low-pass band.

    Returns:
      (delta_p, amplitude): the additive projector-column correction
      (zero where gated) and the demodulated carrier amplitude (~A/2).
    """
    h, w = frame.shape
    two_pi = 2.0 * math.pi
    f = frame.astype(jnp.float32)
    wgt = _tri_weight(h, w, win_v, win_u)
    dc = _tri_sum(f, win_v, win_u) / wgt
    iac = f - dc
    phi = (two_pi / period) * proj_u_pred.astype(jnp.float32)
    c = _tri_sum(iac * jnp.cos(phi), win_v, win_u)
    s = _tri_sum(iac * jnp.sin(phi), win_v, win_u)
    amp = jnp.sqrt(c * c + s * s) / wgt
    delta_phi = jnp.arctan2(-s, c)
    delta_p = delta_phi * jnp.float32(period / two_pi)
    if per_pixel:
        # Per-pixel absolute reading, referenced to the windowed fix.
        cos_phi = jnp.clip(iac / jnp.maximum(2.0 * amp, 1e-6),
                           -1.0, 1.0)
        phi_mag = jnp.arccos(cos_phi)                  # [0, pi]
        phi_ref = phi + delta_phi                      # window-corrected
        # wrap(x) to (-pi, pi] without trig round trips.
        def wrap(x):
            return x - two_pi * jnp.round(x / two_pi)
        d_pos = wrap(phi_mag - phi_ref)
        d_neg = wrap(-phi_mag - phi_ref)
        d_px = jnp.where(jnp.abs(d_pos) <= jnp.abs(d_neg), d_pos, d_neg)
        conf = 1.0 - cos_phi * cos_phi                 # sin^2(phi)
        delta_p = (delta_phi + conf * d_px) * jnp.float32(period / two_pi)
    ok = (amp > amp_floor) & (proj_u_pred > 0)
    if max_carrier_gradient and math.isfinite(max_carrier_gradient):
        # Carrier-consistency gate (see docstring): amplitude-gated
        # mean of the wrapped column gradient of delta_phi, evaluated
        # PER GATE_BAND-ROW BAND. A mis-specified period's constant
        # gradient trips every band; a genuinely local gradient (depth
        # rim, fast local motion) locks out only its own band.
        def wrapg(x):
            return x - two_pi * jnp.round(x / two_pi)
        gx = wrapg(delta_phi[:, 1:] - delta_phi[:, :-1])
        gm = (ok[:, 1:] & ok[:, :-1]).astype(jnp.float32)
        hb = -(-h // GATE_BAND) * GATE_BAND
        def band_sum(x):
            xp = jnp.pad(x, ((0, hb - h), (0, 0)))
            return xp.reshape(hb // GATE_BAND, GATE_BAND,
                              x.shape[1]).sum((1, 2))
        g = band_sum(gx * gm) / jnp.maximum(band_sum(gm), 1.0)
        gate = jnp.abs(g) <= jnp.float32(max_carrier_gradient)
        gate_rows = jnp.repeat(gate, GATE_BAND)[:h]
        ok = ok & gate_rows[:, None]
    return jnp.where(ok, delta_p, 0.0), amp


@functools.partial(jax.jit, static_argnames=("period_nominal", "win_u",
                                             "win_v", "amp_floor",
                                             "iters"))
def estimate_period(frame: jax.Array, proj_u: jax.Array,
                    period_nominal: float, win_u: int = 9,
                    win_v: int = 9, amp_floor: float = 8.0,
                    iters: int = 2) -> jax.Array:
    """Refine the stripe period from one dynamic frame + an absolute
    projector map (e.g. the frame-0 decode).

    The closed-loop failure mode the carrier-consistency gate protects
    against — a lock period mis-specified by >= ~1% — is fully
    observable in a single frame: demodulating at T_nom against the
    TRUE map leaves delta_phi with slope m = d(delta_phi)/dP =
    2*pi*(1/T_true - 1/T_nom), so

        1/T_true = 1/T_nom + m / (2*pi)

    with m estimated by amplitude-gated least squares of the wrapped
    column gradient of delta_phi against the column gradient of P. One
    refinement round removes the first-order window decorrelation a
    large mismatch causes (``iters=2`` re-demodulates at the first
    estimate); valid to ~+-10% initial error (beyond that the carrier
    rotates > ~1 rad across the lock window and the demodulated
    amplitude collapses). Accuracy on the synthetic rig: ~0.15-0.25%
    from up to a 10% wrong start, noise- and size-independent — the
    residual is the demod's own chirp bias (perspective makes dP/du
    vary across the image, and the windowed phase estimate is biased
    by the local chirp), which the locked tracker's per-pixel
    refinement absorbs: well inside the carrier gate's < 0.7%
    pass band (tests/test_demod_adversarial.py).

    Returns the refined period as a scalar f32 array. The runner calls
    this at init when phase lock is enabled (the manifest's
    stripe_period is treated as nominal), closing the loop the gate's
    failure envelope documents.
    """
    two_pi = 2.0 * math.pi
    h, w = frame.shape
    f = frame.astype(jnp.float32)
    pu = proj_u.astype(jnp.float32)
    wgt = _tri_weight(h, w, win_v, win_u)
    dc = _tri_sum(f, win_v, win_u) / wgt
    iac = f - dc
    g_pu = pu[:, 1:] - pu[:, :-1]

    def wrap(x):
        return x - two_pi * jnp.round(x / two_pi)

    def refine(t):
        phi = (two_pi / t) * pu
        c = _tri_sum(iac * jnp.cos(phi), win_v, win_u)
        s = _tri_sum(iac * jnp.sin(phi), win_v, win_u)
        amp = jnp.sqrt(c * c + s * s) / wgt
        dphi = jnp.arctan2(-s, c)
        ok = (amp > amp_floor) & (pu > 0)
        m_ok = (ok[:, 1:] & ok[:, :-1]).astype(jnp.float32)
        g_phi = wrap(dphi[:, 1:] - dphi[:, :-1])
        num = jnp.sum(g_phi * g_pu * m_ok)
        den = jnp.maximum(jnp.sum(g_pu * g_pu * m_ok), 1e-6)
        m = num / den
        return 1.0 / (1.0 / t + m / jnp.float32(two_pi))

    t = jnp.float32(period_nominal)
    for _ in range(iters):
        t = refine(t)
    return t


def suggest_lock_window(proj_u0: np.ndarray, period: float,
                        periods_per_window: float = 1.0,
                        max_window: int = 64) -> int:
    """Pick the lock-in triangle half-width (camera px) from the
    frame-0 absolute map: the median local carrier period
    T / median(dP/du), times ``periods_per_window``. The default 1.0
    places the triangle's sinc^2 NULL exactly at the carrier frequency
    (box width == one carrier period), which is the optimal 1x/2x
    leakage rejection per unit of support. Host-side, run once before
    the jitted loop."""
    pu = np.asarray(proj_u0, np.float64)
    g = 0.5 * (np.roll(pu, -1, axis=1) - np.roll(pu, 1, axis=1))
    g = g[1:-1, 1:-1]
    valid = (pu[1:-1, 1:-1] > 0) & (np.abs(g) > 1e-3)
    med = float(np.median(np.abs(g[valid]))) if valid.any() else 1.0
    win = int(round(periods_per_window * period / max(med, 1e-3)))
    win = int(np.clip(win, 3, max_window))
    return win if win % 2 else win - 1            # odd, bounded
