"""`shard_map` image-tile-parallel pipeline stages.

Each device owns an (H/ty, W/tx) tile of the camera image. Decode and
triangulation are pointwise and shard trivially; the dynamic stripe
tracker is a windowed stencil and gathers an 11-px halo
(RECO_WINDOW_SIZE//2 + 1, StaticParameters.cpp:38) via `ppermute` before
running the same raw kernels as the single-device path
(slc_tpu.ops.stripe), then applies the reference's interior masks in
GLOBAL image coordinates so the tiled result is bit-identical to the
single-device result (the 21-px window means every point where tiled and
golden border handling could differ carries a zero, see
tiled_dynamic_step).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from slc_tpu.calib import TriangulationTables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import TrackerState
from slc_tpu.ops.filters import box_blur_3x3
from slc_tpu.ops.gray import decode_gray
from slc_tpu.ops.phase import decode_phase, modulation
from slc_tpu.ops.stripe import (box_sum_vertical_raw, windowed_extrema_raw,
                                select_delta_p)
from slc_tpu.ops.unwrap import gray_assisted_merge, heterodyne_unwrap
from slc_tpu.parallel.halo import (halo_exchange, halo_crop, global_offsets)
from slc_tpu.parallel.mesh import SCAN, TILE_Y, TILE_X
from slc_tpu.pipeline import FrameResult

SPEC2 = P(TILE_Y, TILE_X)            # (H, W) image sharded by tile
SPEC3 = P(None, TILE_Y, TILE_X)      # (N, H, W) image stack


def tables_spec() -> TriangulationTables:
    """PartitionSpec pytree for TriangulationTables: per-pixel maps are
    tiled, scalars replicated."""
    s = P()
    return TriangulationTables(a=s, b=s, c=SPEC2, d=SPEC2,
                               fx=s, fy=s, cx=s, cy=s)


def state_spec() -> TrackerState:
    return TrackerState(proj_u=SPEC2, strip_w=SPEC2, strip_b=SPEC2,
                        z=SPEC2, frame_idx=P())


def shard_image(x: jax.Array, mesh) -> jax.Array:
    """Place an (..., H, W) array tile-sharded on the mesh."""
    ndim = x.ndim
    spec = P(*([None] * (ndim - 2) + [TILE_Y, TILE_X]))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _tile_triangulate(proj_u: jax.Array, tables: TriangulationTables,
                      fov_min: float, fov_max: float,
                      valid: Optional[jax.Array] = None
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-tile triangulation + back-projection with GLOBAL pixel
    coordinates (the tiled analog of slc_tpu.ops.triangulate; the
    back-projection u/v grids must be global, CCalculation.cpp:756-771)."""
    h, w = proj_u.shape
    row0, col0 = global_offsets(h, w)
    p = proj_u.astype(jnp.float32)
    denom = tables.c - tables.d * p
    z = (tables.b * p - tables.a) / denom
    hole = p == 0
    if valid is not None:
        hole = hole | jnp.logical_not(valid)
    z = jnp.where(hole | (z < fov_min) | (z > fov_max), 0.0, z)
    u = (col0 + jnp.arange(w, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    v = (row0 + jnp.arange(h, dtype=jnp.int32)[:, None]).astype(jnp.float32)
    x = z * ((u - tables.cx) / tables.fx)
    y = z * ((v - tables.cy) / tables.fy)
    return x, y, z


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def tiled_absolute_decode(gray_images: jax.Array, phase_images: jax.Array,
                          tables: TriangulationTables, cfg: SystemConfig,
                          mesh) -> FrameResult:
    """Tile-parallel frame-0 absolute decode + triangulation. Decode and
    merge are pointwise — no halo; only the back-projection needs global
    coordinates."""
    def f(gray, phase, tb):
        g = decode_gray(gray, cfg.gray_bits, cfg.pro_w)
        ph = decode_phase(phase, cfg.phase_period)
        pu = gray_assisted_merge(g, ph, cfg.gray_period, cfg.phase_period)
        x, y, z = _tile_triangulate(pu, tb, cfg.fov_min, cfg.fov_max)
        return FrameResult(x=x, y=y, z=z, proj_u=pu)

    fr_spec = FrameResult(x=SPEC2, y=SPEC2, z=SPEC2, proj_u=SPEC2)
    return shard_map(f, mesh=mesh,
                     in_specs=(SPEC3, SPEC3, tables_spec()),
                     out_specs=fr_spec)(gray_images, phase_images, tables)


@functools.partial(jax.jit, static_argnames=("cfg", "het", "mesh",
                                             "min_modulation"))
def tiled_heterodyne_decode(fringe_images: jax.Array,
                            tables: TriangulationTables,
                            cfg: SystemConfig, het, mesh,
                            min_modulation: float = 2.0) -> FrameResult:
    """Tile-parallel multi-frequency heterodyne decode + triangulation
    (BASELINE config 2; pipeline.decode_heterodyne_frame semantics).
    Phase extraction, the beat cascade, and the modulation mask are all
    pointwise — no halo; only the back-projection needs global pixel
    coordinates (_tile_triangulate)."""
    n = het.phase_steps
    periods = het.periods(cfg.pro_w)

    def f(imgs, tb):
        wrapped, mods = [], []
        for i, period in enumerate(periods):
            stack = imgs[i * n:(i + 1) * n]
            wrapped.append(decode_phase(stack, float(period)))
            mods.append(modulation(stack))
        pu = heterodyne_unwrap(jnp.stack(wrapped), periods,
                               float(cfg.pro_w))
        valid = None
        if min_modulation is not None:
            valid = functools.reduce(jnp.minimum, mods) > min_modulation
            pu = jnp.where(valid, pu, 0.0)
        x, y, z = _tile_triangulate(pu, tb, cfg.fov_min, cfg.fov_max,
                                    valid)
        return FrameResult(x=x, y=y, z=z, proj_u=pu)

    fr_spec = FrameResult(x=SPEC2, y=SPEC2, z=SPEC2, proj_u=SPEC2)
    return shard_map(f, mesh=mesh,
                     in_specs=(SPEC3, tables_spec()),
                     out_specs=fr_spec)(fringe_images, tables)


def _tile_stripe_regression(frame: jax.Array, window: int, subpixel: bool,
                            img_h: int, img_w: int, extend: int
                            ) -> Tuple[jax.Array, jax.Array]:
    """Stripe regression on one tile with halo exchange; returns offset
    maps extended by ``extend`` (<= window//2) pixels of valid neighbor
    data on every side, interior-masked in global coordinates."""
    r = window // 2
    # +1: the sub-pixel parabola tracks val_sum at offsets -(r+1) and +r,
    # one beyond the scan window (slc_tpu.ops.stripe.windowed_extrema_raw).
    hw = r + extend + 1
    h, w = frame.shape
    row0, col0 = global_offsets(h, w)

    fe = halo_exchange(frame, hw, hw)
    vs = box_sum_vertical_raw(fe, window)
    # Reference interior mask (CCalculation.cpp:801,817) in global coords
    # of the extended tile.
    rows = row0 - hw + jnp.arange(h + 2 * hw)[:, None]
    cols = col0 - hw + jnp.arange(w + 2 * hw)[None, :]
    interior = ((rows >= r) & (rows < img_h - r)
                & (cols >= r) & (cols < img_w - r))
    vs = jnp.where(interior, vs, 0.0)
    sw, sb = windowed_extrema_raw(vs, window, subpixel)
    sw = jnp.where(interior, sw, 0.0)
    sb = jnp.where(interior, sb, 0.0)
    crop = hw - extend
    return halo_crop(sw, crop, crop), halo_crop(sb, crop, crop)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "subpixel"))
def tiled_stripe_regression(frame: jax.Array, cfg: SystemConfig, mesh,
                            subpixel: bool = True
                            ) -> Tuple[jax.Array, jax.Array]:
    """Tile-parallel CCalculation::StripRegression
    (CCalculation.cpp:789-891), bit-identical to the single-device path."""
    def f(fr):
        return _tile_stripe_regression(fr, cfg.reco_window, subpixel,
                                       cfg.cam_h, cfg.cam_w, extend=0)
    return shard_map(f, mesh=mesh, in_specs=(SPEC2,),
                     out_specs=(SPEC2, SPEC2))(frame)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "scale_gradient",
                                    "subpixel", "robust"),
                   donate_argnames=("state",))
def tiled_dynamic_step(state: TrackerState, frame: jax.Array,
                       tables: TriangulationTables, cfg: SystemConfig,
                       mesh, scale_gradient: bool = True,
                       subpixel: bool = True, robust: bool = True
                       ) -> Tuple[TrackerState, FrameResult]:
    """Tile-parallel dynamic frame update (CCalculation.cpp:221-316),
    numerically identical to slc_tpu.dynamic.dynamic_step: the stripe
    offsets are interior-masked (zero within window//2 = 10 px of the
    image border), so every pixel where the tiled border handling of the
    3x3 blur / gradient differs from the single-device reflect/wrap
    border carries a zero delta.
    """
    r = cfg.reco_window // 2

    def f(st: TrackerState, fr, tb):
        h, w = fr.shape
        # Stripe offsets on core+1 so the 3x3 blur of deltaP is exact.
        sw1, sb1 = _tile_stripe_regression(fr, cfg.reco_window, subpixel,
                                           cfg.cam_h, cfg.cam_w, extend=1)
        pw1 = halo_exchange(st.strip_w, 1, 1)
        pb1 = halo_exchange(st.strip_b, 1, 1)
        dp1 = select_delta_p(pw1, pb1, sw1, sb1, robust=robust)
        dp = halo_crop(box_blur_3x3(dp1), 1, 1)      # CCalculation.cpp:650
        if scale_gradient:
            pue = halo_exchange(st.proj_u, 0, 1)
            g = 0.5 * (pue[:, 2:] - pue[:, :-2])
            dp = dp * jnp.clip(g, 0.2, 5.0)
        proj_u = st.proj_u + dp                      # CCalculation.cpp:652-660
        x, y, z = _tile_triangulate(proj_u, tb, cfg.fov_min, cfg.fov_max)
        new_state = TrackerState(
            proj_u=proj_u, strip_w=halo_crop(sw1, 1, 1),
            strip_b=halo_crop(sb1, 1, 1), z=z,
            frame_idx=st.frame_idx + 1)
        return new_state, FrameResult(x=x, y=y, z=z, proj_u=proj_u)

    fr_spec = FrameResult(x=SPEC2, y=SPEC2, z=SPEC2, proj_u=SPEC2)
    return shard_map(f, mesh=mesh,
                     in_specs=(state_spec(), SPEC2, tables_spec()),
                     out_specs=(state_spec(), fr_spec))(state, frame, tables)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "scale_gradient",
                                    "subpixel", "robust"),
                   donate_argnames=("states",))
def tiled_batched_dynamic_step(states: TrackerState, frames: jax.Array,
                               tables: TriangulationTables,
                               cfg: SystemConfig, mesh,
                               scale_gradient: bool = True,
                               subpixel: bool = True,
                               robust: bool = True):
    """Data parallelism over independent scans x image-tile parallelism:
    the full multi-device step (SURVEY.md §2 parallelism table — data
    parallelism over the scan axis, which spans hosts at scale; halo
    exchange over the tile axes).

    ``states``/``frames`` carry a leading scan axis of size
    mesh.shape['scan'] (one scan sequence per scan-group). Returns
    (new_states, results, metrics) where ``metrics`` are global
    (psum-reduced over every mesh axis): valid-pixel fraction and mean
    depth — the per-frame observability stats of SURVEY.md §5.
    """
    s3 = P(SCAN, TILE_Y, TILE_X)
    st_spec = TrackerState(proj_u=s3, strip_w=s3, strip_b=s3, z=s3,
                           frame_idx=P(SCAN))
    fr_spec = FrameResult(x=s3, y=s3, z=s3, proj_u=s3)

    def f(st: TrackerState, fr, tb):
        st1 = jax.tree.map(lambda a: a[0], st)       # local scan dim == 1
        h, w = fr.shape[-2:]
        sw1, sb1 = _tile_stripe_regression(fr[0], cfg.reco_window,
                                           subpixel, cfg.cam_h, cfg.cam_w,
                                           extend=1)
        pw1 = halo_exchange(st1.strip_w, 1, 1)
        pb1 = halo_exchange(st1.strip_b, 1, 1)
        dp1 = select_delta_p(pw1, pb1, sw1, sb1, robust=robust)
        dp = halo_crop(box_blur_3x3(dp1), 1, 1)
        if scale_gradient:
            pue = halo_exchange(st1.proj_u, 0, 1)
            g = 0.5 * (pue[:, 2:] - pue[:, :-2])
            dp = dp * jnp.clip(g, 0.2, 5.0)
        proj_u = st1.proj_u + dp
        x, y, z = _tile_triangulate(proj_u, tb, cfg.fov_min, cfg.fov_max)
        new_st = TrackerState(
            proj_u=proj_u, strip_w=halo_crop(sw1, 1, 1),
            strip_b=halo_crop(sb1, 1, 1), z=z,
            frame_idx=st1.frame_idx + 1)
        axes = (SCAN, TILE_Y, TILE_X)
        metrics = {
            "valid_frac": jax.lax.pmean((z > 0).mean(), axes),
            "mean_z": jax.lax.pmean(z.mean(), axes),
        }
        expand = lambda a: a[None]
        return (jax.tree.map(expand, new_st),
                jax.tree.map(expand, FrameResult(x=x, y=y, z=z,
                                                 proj_u=proj_u)),
                metrics)

    met_spec = {"valid_frac": P(), "mean_z": P()}
    return shard_map(f, mesh=mesh,
                     in_specs=(st_spec, s3, tables_spec()),
                     out_specs=(st_spec, fr_spec, met_spec)
                     )(states, frames, tables)
