"""Multi-scan fusion: Schur-complement bundle adjustment
(BASELINE config 5; no reference equivalent — the reference is strictly
single-scan).

Model: S scans with unknown world-from-scan poses (R_s, t_s) observe a
set of L shared landmarks; observation y_{s,l} is the landmark in scan
s's local frame (in practice: a feature point triangulated from the
scan's depth map). Gauss-Newton on

    min sum_{s,l} m_{s,l} || R_s y_{s,l} + t_s - X_l ||^2

over poses AND landmark positions X. Each GN step eliminates the
landmarks through the Schur complement:

    S_cc = H_cc - H_cl H_ll^{-1} H_lc      (6S x 6S, dense, tiny)
    delta_c = solve(S_cc, b_c - H_cl H_ll^{-1} b_l)
    delta_l = H_ll^{-1} (b_l - H_lc delta_c)

Distribution (slc_tpu.parallel mesh): landmarks are sharded across all
devices; every Schur term is a sum over landmarks, so each device
reduces its local landmarks and a single `psum` forms the global
reduced system, which is solved replicated (96 x 96 for 16 scans). The
landmark back-substitution is purely local: data parallelism across
devices and hosts with one tiny collective per GN iteration.

Gauge freedom is fixed by freezing scan 0's pose.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from slc_tpu import se3


def synthetic_problem(rng, s: int = 6, l: int = 64, noise: float = 0.0,
                      drop: float = 0.2):
    """Synthetic BA problem shared by tests and bench: ground-truth
    poses on a small arc + landmarks in a box; observations in
    scan-local frames, y = R^T (X - t). Returns
    (obs (S,L,3), mask (S,L), rot_gt (S,3,3), trans_gt (S,3))."""
    import numpy as np
    angles = np.linspace(0, 0.4, s)
    rot_gt = np.stack([np.asarray(se3.exp_so3(jnp.asarray(
        [0.0, a, 0.05 * a], jnp.float32))) for a in angles])
    trans_gt = np.stack([np.array([3.0 * a, 0.2 * a, 0.1 * a])
                         for a in angles]).astype(np.float32)
    landmarks = rng.uniform(-5, 5, size=(l, 3)).astype(np.float32)
    landmarks[:, 2] += 20.0

    obs = np.stack([
        (landmarks - trans_gt[i]) @ rot_gt[i]      # R^T (X - t)
        for i in range(s)])
    if noise:
        obs = obs + rng.normal(0, noise, obs.shape)
    mask = (rng.uniform(size=(s, l)) > drop).astype(np.float32)
    mask[0] = 1.0                                  # anchor scan sees all
    return (jnp.asarray(obs, jnp.float32), jnp.asarray(mask),
            jnp.asarray(rot_gt, jnp.float32), jnp.asarray(trans_gt))


def _highest_precision(fn):
    """Trace ``fn`` at "highest" matmul precision. On the GPU a float32
    contraction may otherwise run in TF32 (10-bit mantissa). On the
    16-scan problem TF32 moved the poses by 1.5e-5 against a host f32
    solve, 5x the 3.2e-6 at "highest" (H100; PERF.md, "TF32"): small,
    but the tensors are tiny (96x96 solve), so full precision is
    free."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def residuals(rot: jax.Array, trans: jax.Array, landmarks: jax.Array,
              obs: jax.Array, mask: jax.Array) -> jax.Array:
    """(S,3,3), (S,3), (L,3), (S,L,3), (S,L) -> masked (S,L,3)."""
    pred = jnp.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    return (pred - landmarks[None]) * mask[..., None]


def _gn_terms(rot, trans, landmarks, obs, mask):
    """Per-landmark GN blocks. Jacobians: d r / d xi_s = [I | -[R y]x],
    d r / d X_l = -I. Returns (h_cc (S,6,6), b_c (S,6),
    h_ll (L,3,3), b_l (L,3), h_cl (S,L,6,3), r)."""
    s, l = mask.shape
    ry = jnp.einsum("sij,slj->sli", rot, obs)               # (S,L,3)
    r = (ry + trans[:, None, :] - landmarks[None]) * mask[..., None]

    eye3 = jnp.eye(3, dtype=r.dtype)
    jp = jnp.concatenate([
        jnp.broadcast_to(eye3, (s, l, 3, 3)),
        -se3.hat(ry)], axis=-1)                             # (S,L,3,6)
    jp = jp * mask[..., None, None]

    h_cc = jnp.einsum("slki,slkj->sij", jp, jp)             # (S,6,6)
    b_c = -jnp.einsum("slki,slk->si", jp, r)                # (S,6)
    # J_l = -I (masked): H_ll = (#obs) I, H_cl = -J_p^T.
    nobs = mask.sum(axis=0)                                 # (L,)
    h_ll = nobs[:, None, None] * eye3[None]
    b_l = jnp.einsum("slk->lk", r)                          # -J_l^T r = +sum r
    h_cl = -jnp.swapaxes(jp, -1, -2)                        # (S,L,6,3)
    return h_cc, b_c, h_ll, b_l, h_cl, r


def _schur_reduce(h_cc, b_c, h_ll, b_l, h_cl, damping):
    """Form the reduced camera system from (possibly local-shard) sums.
    Returns (s_cc (S,6,S,6) flattened contributions, rhs (S,6),
    h_ll_inv). ``damping`` is RELATIVE (Levenberg-Marquardt style,
    lambda * diag): pose blocks mix |p|^2-scaled rotation terms with
    O(#obs) translation terms, so absolute damping cannot regularize
    the near-null directions (e.g. sliding along a planar scene)
    without crushing the well-conditioned ones."""
    s, l = h_cl.shape[0], h_cl.shape[1]
    d_ll = jnp.einsum("lii->l", h_ll)[:, None, None] / 3.0
    h_ll_inv = jnp.linalg.inv(
        h_ll + (damping * d_ll + 1e-12) * jnp.eye(3, dtype=h_ll.dtype))
    # W_l = H_cl H_ll^{-1}: (S,L,6,3)
    w = jnp.einsum("slij,ljk->slik", h_cl, h_ll_inv)
    # Off-diagonal coupling: sum_l W_s H_lc_s' = (S,6,S',6)
    s_off = jnp.einsum("slik,tljk->sitj", w, h_cl)
    rhs_red = b_c - jnp.einsum("slik,lk->si", w, b_l)
    return s_off, rhs_red, h_ll_inv


@_highest_precision
def gn_step(rot, trans, landmarks, obs, mask,
            damping: float = 1e-3,
            reduce_fn=None) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One Gauss-Newton step; ``reduce_fn`` sums Schur terms across
    landmark shards (identity locally, `psum` under shard_map)."""
    s = rot.shape[0]
    h_cc, b_c, h_ll, b_l, h_cl, _ = _gn_terms(rot, trans, landmarks, obs,
                                              mask)
    s_off, rhs_red, h_ll_inv = _schur_reduce(h_cc, b_c, h_ll, b_l, h_cl,
                                             damping)
    if reduce_fn is not None:
        h_cc = reduce_fn(h_cc)
        s_off = reduce_fn(s_off)
        rhs_red = reduce_fn(rhs_red)

    diag_cc = jnp.einsum("sii->si", h_cc)
    lm_term = damping * jax.vmap(jnp.diag)(diag_cc) \
        + 1e-12 * jnp.eye(6, dtype=h_cc.dtype)
    a = (jax.scipy.linalg.block_diag(*(h_cc + lm_term))
         .reshape(s, 6, s, 6) - s_off)
    # Gauge fix: freeze scan 0 (identity rows/cols, zero rhs).
    a = a.reshape(6 * s, 6 * s)
    fix = jnp.arange(6)
    a = a.at[fix, :].set(0.0).at[:, fix].set(0.0)
    a = a.at[fix, fix].set(1.0)
    rhs = rhs_red.reshape(-1).at[fix].set(0.0)

    delta_c = jnp.linalg.solve(a, rhs).reshape(s, 6)

    # Landmark back-substitution (local to each shard).
    # b_l - H_lc delta_c ; H_lc = H_cl^T over scans.
    corr = b_l - jnp.einsum("slij,si->lj", h_cl, delta_c)
    delta_l = jnp.einsum("lij,lj->li", h_ll_inv, corr)

    # Update parameterization matching the Jacobian [I | -[Ry]x]:
    # R' = exp(w) R, t' = t + dt (translation NOT rotated).
    d_rot, d_t = se3.exp_se3(delta_c)
    new_rot = d_rot @ rot
    new_trans = trans + d_t
    return new_rot, new_trans, landmarks + delta_l


def _gn_terms_p2l(rot, trans, landmarks, normals, obs, mask, center):
    """Point-to-plane GN blocks: scalar residual e = n_l . (R_s y + t_s
    - X_l) with the landmark's world normal n_l and rotation levers
    centered on ``center`` (S, 3). J_pose = [n | -(n x (pred - c))]
    (1x6). Point-to-plane kills the tangential-sliding null directions
    of point-to-point projective association (the standard ICP result);
    centroid-centered rotation keeps the pose Hessian conditioned at
    f32 (origin-centered levers of O(60) give condition ~|p|^4)."""
    ry = jnp.einsum("sij,slj->sli", rot, obs)               # (S,L,3)
    pred = ry + trans[:, None, :]
    e = jnp.einsum("lk,slk->sl", normals,
                   pred - landmarks[None]) * mask            # (S,L)

    # Huber reweighting (delta = 3x the masked-mean |e|): occlusion
    # boundaries and normal flips produce heavy-tailed residuals that
    # plain least squares lets dominate the step.
    mean_abs = (jnp.abs(e).sum() / jnp.maximum(mask.sum(), 1.0))
    delta = 3.0 * mean_abs + 1e-6
    w_rob = jnp.sqrt(jnp.minimum(1.0, delta / (jnp.abs(e) + 1e-12)))
    e = e * w_rob

    lever = pred - center[:, None, :]                        # (S,L,3)
    n_b = jnp.broadcast_to(normals[None], ry.shape)          # (S,L,3)
    j = jnp.concatenate([n_b, -jnp.cross(n_b, lever)],
                        axis=-1)                             # (S,L,6)
    j = j * (mask * w_rob)[..., None]

    h_cc = jnp.einsum("sli,slj->sij", j, j)                  # (S,6,6)
    b_c = -jnp.einsum("sli,sl->si", j, e)                    # (S,6)
    return h_cc, b_c, e


@_highest_precision
def gn_step_p2l(rot, trans, landmarks, normals, obs, mask,
                damping: float = 1e-3, reduce_fn=None):
    """One point-to-plane Gauss-Newton step over POSES ONLY.

    Landmarks stay fixed: a free landmark under scalar point-to-plane
    residuals has 3 DoF against <= a handful of equations, so it can
    absorb every observation and leave the poses unconstrained (the
    system reaches zero residual at arbitrary poses). Classic ICP
    therefore treats the associated surface anchors as data; they are
    re-estimated only in the association round. With fixed landmarks
    the pose Hessian is block-diagonal — no Schur coupling — and the
    distributed reduction is one psum of (centroid, H_cc, b_c) over
    landmark shards."""
    red = reduce_fn if reduce_fn is not None else (lambda x: x)

    pred = jnp.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    csum = red((pred * mask[..., None]).sum(1))              # (S,3)
    nobs = jnp.maximum(red(mask.sum(1)), 1.0)                # (S,)
    center = csum / nobs[:, None]

    h_cc, b_c, _ = _gn_terms_p2l(rot, trans, landmarks, normals, obs,
                                 mask, center)
    h_cc = red(h_cc)
    b_c = red(b_c)

    diag_cc = jnp.einsum("sii->si", h_cc)
    lm_term = damping * jax.vmap(jnp.diag)(diag_cc) \
        + 1e-9 * jnp.eye(6, dtype=h_cc.dtype)
    delta_c = jnp.linalg.solve(h_cc + lm_term, b_c[..., None])[..., 0]
    delta_c = delta_c.at[0].set(0.0)                         # gauge

    # Centroid-centered update: pred' = exp(w)(pred - c) + c + dt, i.e.
    # R' = exp(w) R, t' = exp(w)(t - c) + c + dt.
    d_rot, d_t = se3.exp_se3(delta_c)
    new_trans = (jnp.einsum("sij,sj->si", d_rot, trans - center)
                 + center + d_t)
    return d_rot @ rot, new_trans, landmarks


@functools.partial(jax.jit, static_argnames=("iters",))
@_highest_precision
def fuse_scans_p2l(obs: jax.Array, mask: jax.Array, normals: jax.Array,
                   init_rot: jax.Array, init_trans: jax.Array,
                   init_landmarks: jax.Array,
                   iters: int = 10, damping: float = 1e-3):
    """Point-to-plane multi-scan alignment (normals (L, 3) in world)."""
    def body(_, carry):
        r, t, x = carry
        return gn_step_p2l(r, t, x, normals, obs, mask, damping)
    return jax.lax.fori_loop(0, iters, body,
                             (init_rot, init_trans, init_landmarks))


@functools.partial(jax.jit, static_argnames=("iters",))
@_highest_precision
def fuse_scans(obs: jax.Array, mask: jax.Array,
               init_rot: Optional[jax.Array] = None,
               init_trans: Optional[jax.Array] = None,
               init_landmarks: Optional[jax.Array] = None,
               iters: int = 10, damping: float = 1e-3):
    """Single-device bundle adjustment.

    Args:
      obs: (S, L, 3) landmark observations in each scan's local frame.
      mask: (S, L) 1.0 where scan s observes landmark l.
    Returns (rot (S,3,3), trans (S,3), landmarks (L,3)).
    """
    s, l = mask.shape
    rot = (init_rot if init_rot is not None
           else jnp.broadcast_to(jnp.eye(3, dtype=obs.dtype), (s, 3, 3)))
    trans = (init_trans if init_trans is not None
             else jnp.zeros((s, 3), obs.dtype))
    if init_landmarks is None:
        # Initialize landmarks as the masked mean of transformed obs.
        pred = jnp.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
        init_landmarks = (pred * mask[..., None]).sum(0) \
            / jnp.maximum(mask.sum(0)[:, None], 1.0)
    lm = init_landmarks

    def body(_, carry):
        r, t, x = carry
        return gn_step(r, t, x, obs, mask, damping)

    return jax.lax.fori_loop(0, iters, body, (rot, trans, lm))


@_highest_precision
def ate_rmse(rot, trans, rot_gt, trans_gt) -> jax.Array:
    """Absolute trajectory error after aligning to the gauge of scan 0:
    express every pose relative to scan 0 in both sets, compare
    translations."""
    r0i, t0i = se3.invert(rot[0], trans[0])
    g0i, g0t = se3.invert(rot_gt[0], trans_gt[0])
    rel_t = jnp.einsum("ij,sj->si", r0i, trans) + t0i
    rel_gt = jnp.einsum("ij,sj->si", g0i, trans_gt) + g0t
    return jnp.sqrt(jnp.mean(jnp.sum((rel_t - rel_gt) ** 2, -1)))
