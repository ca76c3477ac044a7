"""Multi-scan registration frontend: projective data association.

Connects the bundle adjustment backend (slc_tpu.fusion) to actual depth
maps. Landmarks are a pixel grid of scan 0's depth map back-projected to
world; each scan's observation of a landmark is found by projecting it
into that scan's camera with the current pose estimate, bilinearly
sampling the scan's depth map, and back-projecting the sampled depth —
projective (ICP-style) association. Alternating associate -> BA rounds
is point-to-point projective ICP over all scans jointly, with the Schur
solve from slc_tpu.fusion (distributable over landmark shards).

No reference equivalent: the reference is single-scan (SURVEY.md §2);
this is BASELINE config 5's frontend.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from slc_tpu import se3, fusion
from slc_tpu.fusion import _highest_precision


def backproject_grid(depth: jax.Array, cam_k: jax.Array, step: int
                     ) -> Tuple[jax.Array, jax.Array]:
    """Sample every ``step``-th pixel: returns (points (L, 3) in the
    camera frame, valid (L,)). L = (H//step) * (W//step), static."""
    h, w = depth.shape
    ys = jnp.arange(0, h - (h % step), step) + step // 2
    xs = jnp.arange(0, w - (w % step), step) + step // 2
    z = depth[ys[:, None], xs[None, :]]
    u = (xs[None, :] - cam_k[0, 2]) / cam_k[0, 0]
    v = (ys[:, None] - cam_k[1, 2]) / cam_k[1, 1]
    pts = jnp.stack([jnp.broadcast_to(u, z.shape) * z,
                     jnp.broadcast_to(v, z.shape) * z, z], axis=-1)
    return pts.reshape(-1, 3), (z > 0).reshape(-1)


def grid_points_normals(depth: jax.Array, cam_k: jax.Array, step: int
                        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(points (L,3), normals (L,3), valid (L,)) at the sampled grid,
    normals from the neighbor cross product (slc_tpu.cloud)."""
    from slc_tpu.cloud import depth_to_cloud, cloud_normals
    h, w = depth.shape
    c = depth_to_cloud(depth, cam_k[0, 0], cam_k[1, 1],
                       cam_k[0, 2], cam_k[1, 2])
    n, ok = cloud_normals(c, depth > 0)
    ys = jnp.arange(0, h - (h % step), step) + step // 2
    xs = jnp.arange(0, w - (w % step), step) + step // 2
    pts = c[ys[:, None], xs[None, :]].reshape(-1, 3)
    nrm = n[ys[:, None], xs[None, :]].reshape(-1, 3)
    valid = ok[ys[:, None], xs[None, :]].reshape(-1)
    # Depth-discontinuity filter: cross-product normals at occlusion
    # edges are garbage; drop grid points whose right/down depth step
    # exceeds 2% of the local depth.
    dz_r = jnp.abs(jnp.roll(depth, -1, 1) - depth)
    dz_d = jnp.abs(jnp.roll(depth, -1, 0) - depth)
    edge = jnp.maximum(dz_r, dz_d) > 0.02 * jnp.maximum(depth, 1e-6)
    smooth = ~edge[ys[:, None], xs[None, :]].reshape(-1)
    return pts, nrm, valid & smooth


def _bilinear(depth: jax.Array, x: jax.Array, y: jax.Array
              ) -> Tuple[jax.Array, jax.Array]:
    """Hole-aware bilinear depth sample at continuous (x, y); returns
    (z, valid). A sample is valid only if all four corners are valid
    and in bounds."""
    h, w = depth.shape
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = jnp.clip(x0, 0, w - 2)
    y0c = jnp.clip(y0, 0, h - 2)
    fx = x - x0c
    fy = y - y0c
    z00 = depth[y0c, x0c]
    z01 = depth[y0c, x0c + 1]
    z10 = depth[y0c + 1, x0c]
    z11 = depth[y0c + 1, x0c + 1]
    ok = inb & (z00 > 0) & (z01 > 0) & (z10 > 0) & (z11 > 0)
    z = (z00 * (1 - fx) * (1 - fy) + z01 * fx * (1 - fy)
         + z10 * (1 - fx) * fy + z11 * fx * fy)
    return z, ok


@functools.partial(jax.jit, static_argnames=("grid_step",))
@_highest_precision
def associate_projective(depths: jax.Array, cam_k: jax.Array,
                         rot: jax.Array, trans: jax.Array,
                         grid_step: int = 8,
                         max_depth_err: float = 1.0
                         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Build (obs (S, L, 3), mask (S, L), landmarks (L, 3)) from (S, H,
    W) depth maps, intrinsics, and current world_from_scan poses.

    Landmarks are the union of every scan's back-projected pixel grid
    (L = S * grid points): a chain of pairwise-overlapping scans stays
    connected even when the ends share no common surface. Landmark
    normals (owner scan's surface normal, rotated to world) are
    returned for the point-to-plane solve.

    Runs at highest matmul precision: the pose transforms contract
    against 3x3 rotations, which a GPU may otherwise evaluate in TF32
    (10-bit mantissa): at landmark magnitudes of ~60 scene units that
    is up to 60 * 2^-11 ~ 0.03 of absolute error per product, above the
    registration's ATE.
    The contractions are tiny; full precision is free."""
    def grid_world(depth_s, rot_s, trans_s):
        pts, nrm, ok = grid_points_normals(depth_s, cam_k, grid_step)
        return (se3.apply(rot_s, trans_s, pts),
                nrm @ rot_s.T, ok)

    lm_s, nrm_s, valid_s = jax.vmap(grid_world)(depths, rot, trans)
    landmarks = lm_s.reshape(-1, 3)                         # (S*G, 3)
    normals = nrm_s.reshape(-1, 3)
    valid0 = valid_s.reshape(-1)

    def per_scan(depth_s, rot_s, trans_s):
        r_inv, t_inv = se3.invert(rot_s, trans_s)
        p_cam = se3.apply(r_inv, t_inv, landmarks)          # scan frame
        z_pred = p_cam[:, 2]
        u = p_cam[:, 0] / jnp.maximum(z_pred, 1e-6) * cam_k[0, 0] \
            + cam_k[0, 2]
        v = p_cam[:, 1] / jnp.maximum(z_pred, 1e-6) * cam_k[1, 1] \
            + cam_k[1, 2]
        z_meas, ok = _bilinear(depth_s, u, v)
        ok = (ok & valid0 & (z_pred > 0)
              & (jnp.abs(z_meas - z_pred) < max_depth_err))
        scale = z_meas / jnp.maximum(z_pred, 1e-6)
        obs_s = p_cam * scale[:, None]      # measured point on the ray
        return jnp.where(ok[:, None], obs_s, 0.0), ok

    obs, mask = jax.vmap(per_scan)(depths, rot, trans)
    # Exclude self-observations: a scan trivially re-observes its own
    # landmarks at zero residual for its CURRENT pose, which under the
    # pose-only point-to-plane solve would anchor every pose to its
    # initial (wrong) value. Only cross-scan constraints carry
    # registration information.
    s = depths.shape[0]
    g = landmarks.shape[0] // s
    owner = jnp.repeat(jnp.arange(s), g)                     # (L,)
    cross = owner[None, :] != jnp.arange(s)[:, None]         # (S, L)
    mask = mask & cross
    return obs, mask.astype(depths.dtype), landmarks, normals


@functools.partial(jax.jit, static_argnames=("n_anchor_landmarks",))
@_highest_precision
def anchor_gauge_align(rot: jax.Array, trans: jax.Array,
                       obs: jax.Array, mask: jax.Array,
                       landmarks: jax.Array, normals: jax.Array,
                       n_anchor_landmarks: int) -> Tuple[jax.Array,
                                                         jax.Array]:
    """Rigid gauge re-registration to the anchor scan.

    The consensus p2l rounds make the scans MUTUALLY consistent, but
    the common-mode rigid offset of the whole ensemble relative to
    scan 0 is only pulled by the ~1/S of observations that reference
    scan-0 landmarks — measured to stall at a nonzero fixed point (the
    consensus landmarks rebuild at the ensemble's own poses every
    association round, so the dilution never resolves). This step
    estimates ONE SE(3) transform G from ALL non-anchor observations
    of anchor-owned landmarks (point-to-plane GN on 6 DoF) and applies
    it to every non-anchor pose: the ensemble's internal registration
    is untouched (rigid motion), chains where only some scans see the
    anchor still correct fully, and the gauge lands on scan 0."""
    g = n_anchor_landmarks
    s = rot.shape[0]
    # World-frame predicted points for observations of anchor landmarks
    # by non-anchor scans.
    pred = jnp.einsum("sij,slj->sli", rot, obs[:, :g]) \
        + trans[:, None, :]                              # (S, g, 3)
    m = mask[:, :g] * (jnp.arange(s) > 0)[:, None]       # exclude scan 0
    x = landmarks[None, :g]
    n = normals[None, :g]

    def gn(carry, _):
        r_acc, t_acc = carry
        p = jnp.einsum("ij,slj->sli", r_acc, pred) + t_acc
        res = jnp.sum(n * (p - x), axis=-1)
        jw = jnp.cross(p, jnp.broadcast_to(n, p.shape))  # d(res)/d(omega)
        j = jnp.concatenate([jw, jnp.broadcast_to(n, p.shape)], -1)
        jm = j * m[..., None]
        h = jnp.einsum("sli,slj->ij", jm, j)
        b = -jnp.einsum("sli,sl->i", jm, res)
        h = h + 1e-6 * jnp.trace(h) / 6.0 * jnp.eye(6) + 1e-12 * jnp.eye(6)
        step = jnp.linalg.solve(h, b)
        dr = se3.exp_so3(step[:3])
        return (dr @ r_acc,
                jnp.einsum("ij,j->i", dr, t_acc) + step[3:]), None

    (d_rot, dt), _ = jax.lax.scan(gn, (jnp.eye(3), jnp.zeros(3)),
                                  None, length=3)
    keep = (jnp.arange(s) == 0)[:, None, None]
    new_rot = jnp.where(keep, rot, d_rot[None] @ rot)
    new_trans = jnp.where(
        keep[..., 0], trans,
        jnp.einsum("ij,sj->si", d_rot, trans) + dt)
    return new_rot, new_trans


def register_scans(depths: jax.Array, cam_k: jax.Array,
                   init_rot: jax.Array, init_trans: jax.Array,
                   rounds: int = 4, gn_iters: int = 5,
                   grid_step: int = 8, max_depth_err: float = 1.0,
                   anchor_gauge: bool = True
                   ) -> Tuple[jax.Array, jax.Array]:
    """Joint multi-scan registration: alternate projective association
    with point-to-plane Schur-complement bundle adjustment (point-to-
    point slides tangentially on smooth surfaces; the normal-projected
    residual does not), then re-register the ensemble's gauge to the
    anchor scan (:func:`anchor_gauge_align`; ``anchor_gauge=False``
    skips it). Returns refined world_from_scan (rot (S,3,3),
    trans (S,3))."""
    rot, trans = (jnp.asarray(init_rot, jnp.float32),
                  jnp.asarray(init_trans, jnp.float32))
    depths = jnp.asarray(depths, jnp.float32)
    cam_k = jnp.asarray(cam_k, jnp.float32)
    for _ in range(rounds):
        obs, mask, lm, normals = associate_projective(
            depths, cam_k, rot, trans, grid_step, max_depth_err)
        rot, trans, _ = fusion.fuse_scans_p2l(
            obs, mask, normals, init_rot=rot, init_trans=trans,
            init_landmarks=lm, iters=gn_iters)
    if anchor_gauge:
        h, w = depths.shape[1:]
        g = (h // grid_step) * (w // grid_step)
        obs, mask, lm, normals = associate_projective(
            depths, cam_k, rot, trans, grid_step, max_depth_err)
        rot, trans = anchor_gauge_align(rot, trans, obs, mask, lm,
                                        normals, g)
    return rot, trans
