"""Streaming dynamic-frame tracker.

The reference's frames 1..99 loop (CCalculation::CalculateOther,
DynaFrame/CCalculation.cpp:208-320) carries exactly three arrays between
frames: the projector map P[f-1], the stripe offsets stripW/stripB[f-1],
and z[f-1] (for the deltaZ diagnostic) — identified in SURVEY.md §5 as the
complete checkpointable state. Here that state is an explicit pytree and
the per-frame update a pure function, so the sequence runs under
``lax.scan`` (offline, all frames on device) or one ``jit`` step at a time
(streaming, see :mod:`slc_tpu.streaming`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from slc_tpu.calib import TriangulationTables
from slc_tpu.config import SystemConfig
from slc_tpu.ops.filters import box_blur_3x3
from slc_tpu.ops.stripe import stripe_regression, select_delta_p
from slc_tpu.ops.triangulate import triangulate_xyz
from slc_tpu.pipeline import FrameResult


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrackerState:
    """Carried state of the dynamic loop (CCalculation.cpp:603-606,
    :656-658, :774)."""
    proj_u: jax.Array     # (H, W) float32 absolute projector map P[f-1]
    strip_w: jax.Array    # (H, W) float32 bright-stripe offsets
    strip_b: jax.Array    # (H, W) float32 dark-stripe offsets
    z: jax.Array          # (H, W) float32 previous depth
    frame_idx: jax.Array  # () int32


@functools.partial(jax.jit, static_argnames=("cfg", "subpixel"))
def init_tracker(frame0: jax.Array, proj_u0: jax.Array, z0: jax.Array,
                 cfg: SystemConfig, subpixel: bool = True) -> TrackerState:
    """Initialize from the absolutely-decoded frame 0
    (CCalculation::StripRegression(0) at CCalculation.cpp:201)."""
    sw, sb = stripe_regression(frame0, cfg.reco_window, subpixel)
    return TrackerState(proj_u=proj_u0.astype(jnp.float32), strip_w=sw,
                        strip_b=sb, z=z0.astype(jnp.float32),
                        frame_idx=jnp.int32(0))


@functools.partial(jax.jit, static_argnames=("cfg", "subpixel"))
def reanchor(state: TrackerState, frame: jax.Array,
             proj_u_abs: jax.Array, z_abs: jax.Array, cfg: SystemConfig,
             subpixel: bool = True) -> TrackerState:
    """Periodic absolute re-anchoring (SURVEY.md §5). The integrated
    map drifts because P[f] = P[f-1] + deltaP accumulates error
    (CCalculation.cpp:656-660) and the reference never corrects it;
    when a fresh absolute decode is available (a full pattern group
    projected mid-sequence), this replaces P and z with it and rebuilds
    the stripe state from the current fringe frame, preserving the
    frame counter."""
    sw, sb = stripe_regression(frame, cfg.reco_window, subpixel)
    return TrackerState(proj_u=proj_u_abs.astype(jnp.float32),
                        strip_w=sw, strip_b=sb,
                        z=z_abs.astype(jnp.float32),
                        frame_idx=state.frame_idx)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "scale_gradient", "subpixel",
                                    "robust", "phase_lock",
                                    "lock_win_u", "lock_win_v"),
                   donate_argnames=("state",))
def dynamic_step(state: TrackerState, frame: jax.Array,
                 tables: TriangulationTables, cfg: SystemConfig,
                 scale_gradient: bool = True, subpixel: bool = True,
                 robust: bool = True, phase_lock: float = None,
                 lock_win_u: int = 9, lock_win_v: int = 9
                 ) -> Tuple[TrackerState, FrameResult]:
    """One dynamic frame (the body of CCalculation::CalculateOther,
    CCalculation.cpp:221-316):

      stripe track -> deltaP select -> 3x3 mean filter -> P += deltaP
      -> triangulate.

    ``scale_gradient`` (framework improvement, default on): the stripe
    offsets are measured in *camera* pixels while P accumulates
    *projector* columns; the reference adds them directly
    (CCalculation.cpp:652-660), implicitly assuming unit magnification
    between the two — valid for its rig but a systematic drift source
    otherwise. The first-order conversion is the local gradient
    g = dP/du of the carried map, so deltaP_proj = g * deltaP_cam.
    Set False for exact reference semantics.

    ``robust`` (framework improvement, default on): mean-combine the
    bright/dark stripe deltas where they agree instead of the
    reference's min-|d| pick — see
    :func:`slc_tpu.ops.stripe.select_delta_p`. The min-|d| rule
    rectifies the sub-pixel estimators' opposite-phase oscillation
    toward zero, a ~9% systematic underestimation of per-frame motion
    that integrates into drift over the 100-frame sequence
    (tests/test_sequence_100.py). Set False for exact reference
    semantics.

    ``phase_lock`` (framework improvement the reference fundamentally
    lacks, VERDICT r3 item 1): the stripe period T of the projected
    dynamic pattern. When set, the wrapped carrier phase embedded in
    *this very frame* is demodulated against the integrated prediction
    (:func:`slc_tpu.ops.demod.stripe_phase_correction`) and P is
    snapped to phase congruence — the open-loop integration
    P[f] = P[f-1] + deltaP (CCalculation.cpp:652-660) then only has to
    be right to +-T/2 per frame while absolute accuracy comes from the
    measurement, turning O(frames) drift into O(1) phase noise.
    ``lock_win_u``/``lock_win_v`` are the lock-in low-pass extents
    (camera px; see demod.suggest_lock_window).

    The state argument is donated: the new state reuses the old
    buffers, keeping the streaming loop allocation-free.
    """
    sw, sb = stripe_regression(frame, cfg.reco_window, subpixel)
    dp = select_delta_p(state.strip_w, state.strip_b, sw, sb,
                        robust=robust)
    dp = box_blur_3x3(dp)                            # CCalculation.cpp:650
    if scale_gradient:
        g = 0.5 * (jnp.roll(state.proj_u, -1, axis=1)
                   - jnp.roll(state.proj_u, 1, axis=1))
        # Holes and depth edges corrupt the finite difference; bound the
        # magnification to a physically sane band.
        dp = dp * jnp.clip(g, 0.2, 5.0)
    proj_u = state.proj_u + dp                       # CCalculation.cpp:652-660
    if phase_lock is not None:
        from slc_tpu.ops.demod import stripe_phase_correction
        dpl, _ = stripe_phase_correction(frame, proj_u, phase_lock,
                                         lock_win_u, lock_win_v)
        proj_u = proj_u + dpl
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max)
    new_state = TrackerState(proj_u=proj_u, strip_w=sw, strip_b=sb, z=z,
                             frame_idx=state.frame_idx + 1)
    return new_state, FrameResult(x=x, y=y, z=z, proj_u=proj_u)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "scale_gradient", "subpixel",
                                    "robust", "phase_lock", "lock_win_u",
                                    "lock_win_v"))
def run_sequence(state: TrackerState, frames: jax.Array,
                 tables: TriangulationTables, cfg: SystemConfig,
                 scale_gradient: bool = True, subpixel: bool = True,
                 robust: bool = True, phase_lock: float = None,
                 lock_win_u: int = 9, lock_win_v: int = 9
                 ) -> Tuple[TrackerState, FrameResult]:
    """Offline batch variant: scan the tracker over (F, H, W) frames.
    Frame-level parallelism is impossible (P[f] depends on P[f-1],
    CCalculation.cpp:656-658); throughput comes from per-frame fusion."""
    def body(s, frame):
        return dynamic_step(s, frame, tables, cfg, scale_gradient,
                            subpixel, robust, phase_lock=phase_lock,
                            lock_win_u=lock_win_u, lock_win_v=lock_win_v)
    return jax.lax.scan(body, state, frames)


def delta_z(result_z: jax.Array) -> jax.Array:
    """Per-frame depth change over a scanned (F, H, W) z stack — the
    reference's m_deltaZ diagnostic (CCalculation.cpp:772-775)."""
    return jnp.diff(result_z, axis=0)
