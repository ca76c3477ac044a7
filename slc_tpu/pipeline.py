"""End-to-end frame pipelines.

The reference's ``CCalculation`` orchestrator (DynaFrame/CCalculation.cpp)
dissolves into pure jit functions:

* :func:`decode_first_frame` — the frame-0 absolute decode
  (CCalculation::FillFirstProjectorU + FillCoordinate,
  CCalculation.cpp:525-592, :666-785),
* :func:`decode_heterodyne_frame` — the multi-frequency variant
  (BASELINE config 2, absent in the reference),

each returning the absolute projector map and the (x, y, z) coordinate
maps. The dynamic per-frame loop lives in :mod:`slc_tpu.dynamic`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from slc_tpu.calib import TriangulationTables
from slc_tpu.config import SystemConfig, HeterodyneConfig
from slc_tpu.ops.filters import bilateral_filter
from slc_tpu.ops.gray import decode_gray
from slc_tpu.ops.phase import decode_phase, modulation
from slc_tpu.ops.triangulate import triangulate_xyz
from slc_tpu.ops.unwrap import gray_assisted_merge, heterodyne_unwrap
from slc_tpu.ops.unwrap_spatial import unwrap_spatial


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameResult:
    """Per-frame reconstruction output (cf. the m_x/m_y/m_zMat arrays,
    CCalculation.cpp:102-121)."""
    x: jax.Array
    y: jax.Array
    z: jax.Array
    proj_u: jax.Array


@functools.partial(jax.jit, static_argnames=("cfg",))
def absolute_projector_map(gray_images: jax.Array, phase_images: jax.Array,
                           cfg: SystemConfig) -> jax.Array:
    """Gray + phase-shift absolute decode: the reference's frame-0 hot
    path (FillFirstProjectorU, CCalculation.cpp:525-592)."""
    gray = decode_gray(gray_images, cfg.gray_bits, cfg.pro_w)
    phase = decode_phase(phase_images, cfg.phase_period)
    return gray_assisted_merge(gray, phase, cfg.gray_period,
                               cfg.phase_period)


@functools.partial(jax.jit, static_argnames=("cfg", "min_modulation"))
def decode_first_frame(gray_images: jax.Array, phase_images: jax.Array,
                       tables: TriangulationTables, cfg: SystemConfig,
                       min_modulation: Optional[float] = None) -> FrameResult:
    """Frame-0 absolute decode + triangulation
    (CCalculation::CalculateFirst, CCalculation.cpp:171-206).

    ``min_modulation`` optionally enables the fringe-modulation validity
    mask (framework improvement over the reference's P==0 hole rule).
    The mask zeroes ``proj_u`` as well as z, matching the heterodyne
    path: masked pixels read as holes (P==0) to every downstream
    consumer.
    """
    proj_u = absolute_projector_map(gray_images, phase_images, cfg)
    valid = None
    if min_modulation is not None:
        valid = modulation(phase_images) > min_modulation
        proj_u = jnp.where(valid, proj_u, 0.0)
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                              valid)
    return FrameResult(x=x, y=y, z=z, proj_u=proj_u)


@functools.partial(jax.jit, static_argnames=("cfg", "het", "min_modulation"))
def decode_heterodyne_frame(fringe_images: jax.Array,
                            tables: TriangulationTables,
                            cfg: SystemConfig, het: HeterodyneConfig,
                            min_modulation: Optional[float] = 2.0
                            ) -> FrameResult:
    """Multi-frequency heterodyne absolute decode + triangulation
    (BASELINE config 2): ``het.num_images`` fringe images, no Gray
    codes.
    """
    n = het.phase_steps
    periods = het.periods(cfg.pro_w)
    assert fringe_images.shape[0] == het.num_images
    wrapped = []
    mods = []
    for i, period in enumerate(periods):
        stack = fringe_images[i * n:(i + 1) * n]
        # decode_phase's (0, T] convention returns exactly x mod T for the
        # pattern model of slc_tpu.patterns (the +0.5 decoder offset is
        # cancelled by the -0.5 px pattern phase origin); a value of T is
        # congruent to 0 and absorbed by the fractional wrap downstream.
        wrapped.append(decode_phase(stack, float(period)))
        mods.append(modulation(stack))
    proj_u = heterodyne_unwrap(jnp.stack(wrapped), periods,
                               float(cfg.pro_w))
    valid = None
    if min_modulation is not None:
        valid = functools.reduce(jnp.minimum, mods) > min_modulation
        proj_u = jnp.where(valid, proj_u, 0.0)
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                              valid)
    return FrameResult(x=x, y=y, z=z, proj_u=proj_u)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "period", "min_modulation",
                                    "unwrap_iters", "filter_depth", "mg"))
def decode_spatial_frame(fringe_images: jax.Array,
                         tables: TriangulationTables, cfg: SystemConfig,
                         period: float,
                         anchor: Optional[jax.Array] = None,
                         min_modulation: float = 2.0,
                         unwrap_iters: int = 300,
                         filter_depth: bool = True,
                         mg: bool = True) -> FrameResult:
    """Single-frequency decode with quality-guided SPATIAL unwrapping
    (BASELINE config 3; no reference equivalent — the reference needs
    Gray codes or temporal continuity for absolute phase):

      N-step decode -> modulation quality -> weighted-LS spatial unwrap
      -> triangulate -> hole-aware bilateral depth filter.

    ``anchor`` optionally pins the global fringe order (e.g. a previous
    absolute map); without it the result is correct up to one global
    period offset, which triangulation maps to a depth offset.
    ``mg`` selects the multigrid-preconditioned CG (default; converges
    at MP scales where plain Jacobi-PCG caps out — see
    ops.unwrap_spatial.vcycle).
    """
    wrapped = decode_phase(fringe_images, period)
    quality = modulation(fringe_images)
    proj_u = unwrap_spatial(wrapped, period, quality=quality,
                            max_iters=unwrap_iters, anchor=anchor,
                            mg=mg)
    valid = quality > min_modulation
    proj_u = jnp.where(valid, proj_u, 0.0)
    x, y, z = triangulate_xyz(proj_u, tables, cfg.fov_min, cfg.fov_max,
                              valid)
    if filter_depth:
        z = bilateral_filter(z)           # depthMapUtils.cpp:179 behavior
    return FrameResult(x=x, y=y, z=z, proj_u=proj_u)
