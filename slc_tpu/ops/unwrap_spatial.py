"""Quality-guided spatial phase unwrapping (BASELINE config 3).

Absent from the reference, which only does Gray-assisted temporal unwrap
(CCalculation.cpp:561-587). The classic sequential approach (priority-
queue flood fill from high-quality seeds) is inherently sequential; the
data-parallel formulation used here is the weighted least-squares unwrap
(Ghiglia-Romero-style):

    minimize  sum_edges w_e (P_i - P_j - d_e)^2

where d_e is the *wrapped* phase difference along the edge (in [-T/2,
T/2)) and the edge weight w_e = min(q_i, q_j) is the quality-guided
gate — low-quality pixels and phase discontinuities get near-zero
weight, which is exactly what the sequential quality-guided order
achieves. The normal equations are a weighted Poisson system solved by
Jacobi-preconditioned conjugate gradient whose matvec is a 5-point
stencil — embarrassingly tile-parallel (1-px halo per matvec, psum dot
products; see slc_tpu.parallel.unwrap_tiled).

The LS solution is then snapped to congruence with the measured wrapped
phase (P = psi + T*round((P_ls - psi)/T)), so wherever the order field
is locally correct the result is *exactly* psi + k T.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def wrap_to_half(d: jax.Array, period: float) -> jax.Array:
    """Wrap values into [-T/2, T/2)."""
    t = jnp.float32(period)
    return d - t * jnp.floor(d / t + 0.5)


def wrapped_gradients(psi: jax.Array, period: float
                      ) -> Tuple[jax.Array, jax.Array]:
    """Forward wrapped differences (dy (H-1, W), dx (H, W-1))."""
    dy = wrap_to_half(psi[1:, :] - psi[:-1, :], period)
    dx = wrap_to_half(psi[:, 1:] - psi[:, :-1], period)
    return dy, dx


def edge_weights(quality: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Quality-guided edge weights w_e = min(q_i, q_j), quality
    normalized to [0, 1] by its max."""
    q = quality / jnp.maximum(quality.max(), 1e-20)
    wy = jnp.minimum(q[1:, :], q[:-1, :])
    wx = jnp.minimum(q[:, 1:], q[:, :-1])
    return wy, wx


def _edge_scatter(dy: jax.Array, dx: jax.Array) -> jax.Array:
    """out_i = sum over incident edges, oriented away from i: the
    shared divergence pattern of the Laplacian matvec and the RHS —
    written with concatenate/subtract rather than scatter-adds, so XLA
    fuses it into elementwise loops instead of emitting scatters."""
    zrow = jnp.zeros((1, dy.shape[1]), dy.dtype)
    zcol = jnp.zeros((dx.shape[0], 1), dx.dtype)
    return (jnp.concatenate([zrow, dy], axis=0)
            - jnp.concatenate([dy, zrow], axis=0)
            + jnp.concatenate([zcol, dx], axis=1)
            - jnp.concatenate([dx, zcol], axis=1))


def _matvec(p: jax.Array, wy: jax.Array, wx: jax.Array) -> jax.Array:
    """(A p)_i = sum_j w_ij (p_i - p_j) over the 4-neighborhood —
    the weighted graph Laplacian as a 5-point stencil."""
    return _edge_scatter(wy * (p[1:, :] - p[:-1, :]),
                         wx * (p[:, 1:] - p[:, :-1]))


def _rhs(dy, dx, wy, wx) -> jax.Array:
    """b_i = sum_j w_ij d_ij with d oriented away from i."""
    return _edge_scatter(wy * dy, wx * dx)


def _diag(wy, wx) -> jax.Array:
    zrow = jnp.zeros((1, wy.shape[1]), wy.dtype)
    zcol = jnp.zeros((wx.shape[0], 1), wx.dtype)
    d = (jnp.concatenate([zrow, wy], axis=0)
         + jnp.concatenate([wy, zrow], axis=0)
         + jnp.concatenate([zcol, wx], axis=1)
         + jnp.concatenate([wx, zcol], axis=1))
    return jnp.maximum(d, 1e-8)


# Multigrid-preconditioner hyperparameters (shared with the tiled
# solver, slc_tpu.parallel.unwrap_tiled — both must use the same cycle
# for the single/tiled lockstep guarantee). nu/omega/coarsest tuned on
# the 2 MP bench scene; omega=1.0 diverges. MG_KDEPTH (round 4) is the
# number of coarse levels whose correction is solved by TWO steps of
# flexible CG preconditioned by the next level (Notay's K-cycle):
# piecewise-constant aggregation alone has level-dependent convergence
# (93 outer iterations at 2 MP as a plain V-cycle); Krylov-accelerating
# the top coarse corrections restores near level-independence for ~2x
# the per-cycle work. MG_OVERCORR is the classic over-correction for
# piecewise-constant aggregation: the PWC coarse basis underestimates
# smooth corrections by ~2x in 2-D, so the plain-V prolongated
# correction below the K levels is scaled by ~2 (the K levels need no
# factor — their flexible-CG step computes the optimal scaling).
# Outer iterations on the 2 MP bench scene at tol 1e-4: KD=3 oc=1 ->
# 17; KD=2 oc=2.0 -> 12 (chosen; also 8 on the box-step scene, 7 on a
# noisy bumpy scene, 0% order error on all); KD=1 oc=2.2 -> 15; KD=3
# oc=2.0 -> 11 (more K work per cycle than the iterations repay);
# plain V oc=2.0 -> 28; plain V oc=1 -> 60+ (stalls); Chebyshev(2-4)
# smoothed plain V -> 60+ (smoothing cannot fix the PWC coarse-basis
# deficit). KD=4 oc=1 diverged — keep KDEPTH <= 3. The coarsest Jacobi
# solve is a chain of dependent tiny ops; 32 sweeps leave the 2 MP
# iteration count unchanged (12) against 96.
MG_NU = 2
MG_OMEGA = 0.9
MG_COARSE_SWEEPS = 32
MG_COARSEST = 32
MG_KDEPTH = 2
MG_OVERCORR = 2.0


# The transfer operators below use reshape-and-reduce rather than strided
# slices: on an H100 the 2 MP solve measured 9.21 ms of device time this
# way against 9.29 ms with strided slices (timed strided, reshape,
# reshape, strided; 11 iterations either way), and the 96x160 CPU solve
# is faster this way too.


def lane_pair_sum(a: jax.Array) -> jax.Array:
    """Sum of adjacent column pairs: (n, 2m) -> (n, m)."""
    return a.reshape(a.shape[0], -1, 2).sum(-1)


def coarsen_weights(wy: jax.Array, wx: jax.Array, h: int, w: int
                    ) -> Tuple[jax.Array, jax.Array]:
    """EXACT Galerkin coarse operator for 2x2 piecewise-constant
    aggregation: A_c = P^T A P of a graph Laplacian is again a graph
    Laplacian whose coarse edge weight is the sum of the fine edge
    weights crossing the cell cut (in-cell edges vanish). The vertical
    cut between coarse rows I, I+1 is fine edge row 2I+1; columns pair
    up within the cell."""
    cut_y = wy[1::2, :]                          # (hc-1, w)
    if w % 2:
        cut_y = jnp.pad(cut_y, ((0, 0), (0, 1)))
    wy_c = lane_pair_sum(cut_y)
    cut_x = wx[:, 1::2]                          # (h, wc-1)
    if h % 2:
        cut_x = jnp.pad(cut_x, ((0, 1), (0, 0)))
    wx_c = cut_x[0::2, :] + cut_x[1::2, :]       # row strides are cheap
    return wy_c, wx_c


def restrict2(x: jax.Array) -> jax.Array:
    """P^T: 2x2 cell sums (zero-padded to even)."""
    h, w = x.shape
    if h % 2 or w % 2:
        x = jnp.pad(x, ((0, h % 2), (0, w % 2)))
    hp, wp = x.shape
    a = x.reshape(hp, wp // 2, 2).sum(-1)
    return a.reshape(hp // 2, 2, wp // 2).sum(1)


def prolong2(e: jax.Array, h: int, w: int) -> jax.Array:
    """P: repeat each coarse value to its 2x2 cell."""
    hc, wc = e.shape
    a = jnp.broadcast_to(e[:, :, None], (hc, wc, 2)).reshape(hc, 2 * wc)
    a = jnp.broadcast_to(a[:, None, :], (hc, 2, 2 * wc)
                         ).reshape(2 * hc, 2 * wc)
    return a[:h, :w]


def build_mg_levels(wy: jax.Array, wx: jax.Array, h: int, w: int,
                    coarsest: int = MG_COARSEST) -> list:
    """Fine-to-coarse hierarchy of (wy, wx, dinv, (h, w)) via the exact
    Galerkin aggregation of :func:`coarsen_weights` (static recursion —
    shapes known at trace time)."""
    levels = [(wy, wx, 1.0 / _diag(wy, wx), (h, w))]
    while min(levels[-1][3]) > coarsest:
        lwy, lwx, _, (lh, lw) = levels[-1]
        cwy, cwx = coarsen_weights(lwy, lwx, lh, lw)
        ch, cw = -(-lh // 2), -(-lw // 2)
        levels.append((cwy, cwx, 1.0 / _diag(cwy, cwx), (ch, cw)))
    return levels


def vcycle(r: jax.Array, levels: list, nu: int = MG_NU,
           omega: float = MG_OMEGA,
           coarse_sweeps: int = MG_COARSE_SWEEPS,
           kdepth: int = MG_KDEPTH) -> jax.Array:
    """One multigrid cycle approximating A^{-1} r: damped-Jacobi
    pre-smooth, exact-Galerkin coarse-grid correction, damped-Jacobi
    post-smooth. The coarse correction at the first ``kdepth`` coarse
    levels is a K-cycle (:func:`_fcg2`: two flexible-CG steps
    preconditioned by the next level's cycle — Notay-style); below
    that, plain V recursion. kdepth=0 reproduces the round-3 symmetric
    V(nu, nu) exactly.

    With kdepth=0 every operation is LINEAR and symmetric in ``r``, a
    valid SPD preconditioner for standard CG. The K-cycle makes the
    preconditioner (mildly) nonlinear, so the outer iteration uses the
    flexible Polak-Ribiere beta (identical to Fletcher-Reeves in exact
    arithmetic for any fixed SPD preconditioner — the mg=False path is
    unchanged in exact arithmetic). The point of the hierarchy: plain
    Jacobi-PCG stalls on low-frequency error (round-2 bench capped at
    300 iterations at 2 MP); the V-cycle contracts each band at its own
    scale; the K-cycle removes the level-count dependence piecewise-
    constant aggregation leaves behind (round-3: 93 iterations at 2 MP;
    round-4: ~20)."""
    wy, wx, dinv, (h, w) = levels[0]
    om = jnp.float32(omega)
    if len(levels) == 1:
        e = om * dinv * r                 # first Jacobi sweep from e=0
        # fori_loop, not unrolled: ~100 unrolled sweep subgraphs made
        # XLA-CPU compile of the enclosing PCG while_loop take minutes.
        def sweep(_, ee):
            return ee + om * dinv * (r - _matvec(ee, wy, wx))
        return jax.lax.fori_loop(0, coarse_sweeps - 1, sweep, e)
    e = om * dinv * r                     # first Jacobi sweep from e=0
    for _ in range(nu - 1):
        e = e + om * dinv * (r - _matvec(e, wy, wx))
    rc = restrict2(r - _matvec(e, wy, wx))
    if kdepth > 0 and len(levels) > 2:
        # K-cycle correction: the flexible-CG step finds the optimal
        # scaling itself — no over-correction factor.
        ec = _fcg2(rc, levels[1:], nu, omega, coarse_sweeps, kdepth - 1)
        e = e + prolong2(ec, h, w)
    else:
        ec = vcycle(rc, levels[1:], nu, omega, coarse_sweeps, 0)
        e = e + jnp.float32(MG_OVERCORR) * prolong2(ec, h, w)
    for _ in range(nu):
        e = e + om * dinv * (r - _matvec(e, wy, wx))
    return e


def _fcg2(b: jax.Array, levels: list, nu: int, omega: float,
          coarse_sweeps: int, kdepth: int) -> jax.Array:
    """Two steps of flexible CG on the coarse system A_c x = b from
    x = 0, preconditioned by this level's own cycle — the K-cycle
    coarse solve (Notay). The second search direction is explicitly
    A-orthogonalized against the first (z0.r1 = 0 by construction, so
    d1.r1 reduces to z1.r1)."""
    wy, wx, _, _ = levels[0]
    z0 = vcycle(b, levels, nu, omega, coarse_sweeps, kdepth)
    v0 = _matvec(z0, wy, wx)
    rho0 = jnp.maximum(jnp.sum(z0 * v0), 1e-30)
    alpha0 = jnp.sum(z0 * b) / rho0
    x1 = alpha0 * z0
    r1 = b - alpha0 * v0
    z1 = vcycle(r1, levels, nu, omega, coarse_sweeps, kdepth)
    v1 = _matvec(z1, wy, wx)
    gam = jnp.sum(z1 * v0) / rho0
    rho1 = jnp.maximum(jnp.sum(z1 * v1) - gam * gam * rho0, 1e-30)
    t = jnp.sum(z1 * r1) / rho1
    return x1 + t * (z1 - gam * z0)


def residues(psi: jax.Array, period: float) -> jax.Array:
    """Phase residues: the loop integral of wrapped gradients around
    each 2x2 plaquette, in fringe orders. Nonzero entries (±1) mark
    points where the wrapped gradient field is not conservative — the
    classical diagnostic that a scene cannot be unwrapped consistently
    along every path (discontinuities, aliasing, noise). Returns an
    (H-1, W-1) int32 charge map."""
    dy, dx = wrapped_gradients(psi, period)
    loop = (dx[:-1, :]          # top edge, left -> right
            + dy[:, 1:]         # right edge, top -> bottom
            - dx[1:, :]         # bottom edge
            - dy[:, :-1])       # left edge
    return jnp.round(loop / jnp.float32(period)).astype(jnp.int32)


def suspect_edges(p: jax.Array, psi: jax.Array, period: float,
                  quality: Optional[jax.Array] = None,
                  weight_floor: float = 0.5) -> jax.Array:
    """Flag pixels where the unwrapped solution CUT a high-confidence
    edge: |(P_i - P_j) - wrapped(psi_i - psi_j)| > T/2 on an edge whose
    quality weight exceeds ``weight_floor`` (relative to max quality).

    On a correct unwrap of a smooth region this is empty; at a genuine
    depth discontinuity or an unwrap failure the cut edges light up —
    so failure modes are FLAGGED, not silently smoothed over. Returns
    an (H, W) bool mask (a pixel is suspect if any of its 4 edges is
    cut)."""
    half = jnp.float32(period) / 2.0
    dy, dx = wrapped_gradients(psi, period)
    if quality is None:
        wy = jnp.ones_like(dy)
        wx = jnp.ones_like(dx)
    else:
        wy, wx = edge_weights(quality.astype(jnp.float32))
    cut_y = (jnp.abs((p[1:, :] - p[:-1, :]) - dy) > half) \
        & (wy > weight_floor)
    cut_x = (jnp.abs((p[:, 1:] - p[:, :-1]) - dx) > half) \
        & (wx > weight_floor)
    out = jnp.zeros(p.shape, bool)
    out = out.at[1:, :].max(cut_y).at[:-1, :].max(cut_y)
    out = out.at[:, 1:].max(cut_x).at[:, :-1].max(cut_x)
    return out


@functools.partial(jax.jit,
                   static_argnames=("period", "max_iters", "return_info",
                                    "mg"))
def unwrap_spatial(psi: jax.Array, period: float,
                   quality: Optional[jax.Array] = None,
                   max_iters: int = 300, tol: float = 3e-4,
                   anchor: Optional[jax.Array] = None,
                   return_info: bool = False,
                   mg: bool = True):
    """Weighted-LS spatial unwrap of wrapped coordinate ``psi`` in
    [0, T).

    Args:
      psi: (H, W) wrapped fringe coordinate.
      quality: (H, W) quality map (e.g. fringe modulation,
        slc_tpu.ops.phase.modulation); None = uniform.
      max_iters: CG iteration cap (static).
      tol: relative residual-norm stopping threshold. The default
        (3e-4, round 5; was 1e-4) is set by what the OUTPUT needs: the
        congruence snap only requires the LS solution within T/2 of the
        true order everywhere, and at 3e-4 the measured per-pixel error
        on the bench/box-step/noisy scenes is orders of magnitude
        below that (0 fringe-order errors, 0 suspects — asserted in
        bench and tests). Pass a tighter tol for the raw LS field.
      anchor: optional (H, W) initial absolute estimate (e.g. the
        previous frame's P, or a coarse heterodyne result); defaults to
        psi itself. The Laplacian's constant nullspace is fixed by
        re-centering on the anchor's weighted mean.
      return_info: also return convergence + failure diagnostics.

    Returns (H, W) float32 absolute coordinate, congruent with psi
    modulo T at every pixel. With ``return_info=True`` returns
    ``(p, info)`` where info = {``cg_iters``, ``rel_residual`` (final
    ||r||/||b||; > tol means the iteration cap hit first),
    ``residue_count`` (nonzero plaquette charges in the input —
    unwrap difficulty), ``suspect`` ((H, W) bool: high-quality edges
    the solution cut — unwrap failures / unmasked discontinuities),
    ``suspect_count``}.
    """
    psi = psi.astype(jnp.float32)
    if quality is None:
        quality = jnp.ones_like(psi)
    dy, dx = wrapped_gradients(psi, period)
    wy, wx = edge_weights(quality.astype(jnp.float32))
    b = _rhs(dy, dx, wy, wx)
    dinv = 1.0 / _diag(wy, wx)
    if mg:
        # Multigrid-preconditioned CG (``vcycle``): plain Jacobi-PCG
        # stalls on low-frequency error at MP scales.
        levels = build_mg_levels(wy, wx, psi.shape[0], psi.shape[1])
        precond = lambda r: vcycle(r, levels)
    else:
        precond = lambda r: dinv * r

    anc = (anchor.astype(jnp.float32) if anchor is not None else psi)
    p0 = anc
    r0 = b - _matvec(p0, wy, wx)
    z0 = precond(r0)
    b_norm = jnp.sqrt(jnp.sum(b * b)) + 1e-20

    def cond(carry):
        _, r, _, _, it = carry
        return (it < max_iters) & (jnp.sqrt(jnp.sum(r * r)) > tol * b_norm)

    def body(carry):
        p, r, z, d, it = carry
        ad = _matvec(d, wy, wx)
        rz = jnp.sum(r * z)
        alpha = rz / jnp.maximum(jnp.sum(d * ad), 1e-20)
        p = p + alpha * d
        r_new = r - alpha * ad
        z_new = precond(r_new)
        # Flexible (Polak-Ribiere+) beta: required for the K-cycle's
        # mildly nonlinear preconditioner; identical to the standard
        # Fletcher-Reeves beta in exact arithmetic for any fixed SPD
        # preconditioner (the clamp is then inactive).
        beta = jnp.maximum(
            jnp.sum(z_new * (r_new - r)) / jnp.maximum(rz, 1e-20), 0.0)
        return p, r_new, z_new, z_new + beta * d, it + 1

    p, r_fin, _, _, iters = jax.lax.while_loop(
        cond, body, (p0, r0, z0, z0, jnp.int32(0)))

    # Remove the nullspace drift relative to the anchor, then snap to
    # congruence with the measurement.
    wsum = jnp.maximum(quality.sum(), 1e-20)
    shift = jnp.sum(quality * (p - anc)) / wsum
    p = p - shift + jnp.round(shift / period) * period
    k = jnp.round((p - psi) / period)
    out = psi + k * jnp.float32(period)
    if not return_info:
        return out
    res = residues(psi, period)
    sus = suspect_edges(out, psi, period, quality)
    # A depth step of k + delta periods leaves a wrapped-gradient error
    # of exactly round(k + delta) periods — self-consistent (zero
    # residues, zero cut edges) and thus undetectable from psi alone.
    # The anchor (a coarse absolute estimate) is the only signal that
    # exposes such whole-region order offsets; flag where the solution
    # moved >= 1 order away from it.
    dis = jnp.abs(out - anc) > jnp.float32(period) / 2.0
    info = {
        "cg_iters": iters,
        "rel_residual": jnp.sqrt(jnp.sum(r_fin * r_fin)) / b_norm,
        "residue_count": jnp.sum(jnp.abs(res)),
        "suspect": sus,
        "suspect_count": jnp.sum(sus),
        "anchor_disagreement": dis,
        "anchor_disagreement_count": jnp.sum(dis),
    }
    return out, info


def unwrap_to_reference(psi: jax.Array, period: float,
                        reference: jax.Array) -> jax.Array:
    """Pointwise temporal re-anchor: choose the fringe order that brings
    psi closest to ``reference`` (e.g. P[f-1] in the dynamic loop or a
    coarse absolute estimate). The cheap O(1) unwrap the spatial solver
    falls back to when a dense prior exists."""
    k = jnp.round((reference.astype(jnp.float32) - psi) / period)
    return psi + k * jnp.float32(period)
