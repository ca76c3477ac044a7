"""Spatial (quality-guided weighted-LS) unwrapping."""

import numpy as np
import jax.numpy as jnp
import pytest

from slc_tpu.ops.unwrap_spatial import (unwrap_spatial, unwrap_to_reference,
                                        wrap_to_half, wrapped_gradients)


def _wrap(x, t):
    return np.mod(x, t)


def test_wrap_to_half():
    d = jnp.asarray([0.0, 19.9, 20.0, -20.0, 39.0, -39.0])
    got = np.asarray(wrap_to_half(d, 40.0))
    np.testing.assert_allclose(got, [0.0, 19.9, -20.0, -20.0, -1.0, 1.0],
                               atol=1e-5)


def test_unwrap_smooth_ramp():
    """A smooth ramp spanning many periods must unwrap exactly (up to the
    global order fixed by the anchor)."""
    t = 32.0
    h, w = 96, 128
    x = np.linspace(0, 6 * t, w)[None, :] + np.linspace(0, t, h)[:, None]
    psi = _wrap(x, t).astype(np.float32)
    got = np.asarray(unwrap_spatial(jnp.asarray(psi), t,
                                    anchor=jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, x, atol=1e-2)


def test_unwrap_self_anchored_recovers_shape():
    """Without an external anchor the global offset is arbitrary (mod T)
    but the unwrapped field must differ from truth by a constant."""
    t = 24.0
    h, w = 64, 96
    x = 30.0 + 40.0 * np.sin(np.linspace(0, 2, w))[None, :] \
        + 10.0 * np.cos(np.linspace(0, 3, h))[:, None]
    psi = _wrap(x, t).astype(np.float32)
    got = np.asarray(unwrap_spatial(jnp.asarray(psi), t, max_iters=600))
    d = got - x
    assert np.abs(d - d.mean()).max() < 5e-2
    # Congruence: result is psi + k*T exactly.
    k = (got - psi) / t
    np.testing.assert_allclose(k, np.round(k), atol=1e-3)


def test_unwrap_quality_guided_across_noise_band(rng):
    """A horizontal band of pure-noise phase with near-zero quality must
    not break propagation between the clean regions above and below."""
    t = 32.0
    h, w = 96, 128
    x = np.linspace(0, 5 * t, w)[None, :] + 0.3 * np.arange(h)[:, None]
    psi = _wrap(x, t)
    q = np.ones((h, w))
    band = slice(40, 48)
    psi[band] = rng.uniform(0, t, size=(8, w))
    q[band] = 1e-3
    got = np.asarray(unwrap_spatial(jnp.asarray(psi, jnp.float32), t,
                                    quality=jnp.asarray(q, jnp.float32),
                                    max_iters=800,
                                    anchor=jnp.asarray(x, jnp.float32)))
    good = np.ones((h, w), bool)
    good[band] = False
    np.testing.assert_allclose(got[good], x[good], atol=1e-2)


def test_unwrap_to_reference():
    t = 40.0
    x = np.linspace(3.0, 600.0, 500)
    psi = jnp.asarray(_wrap(x, t), jnp.float32)
    ref = jnp.asarray(x + np.random.default_rng(0).uniform(
        -15, 15, x.shape), jnp.float32)
    got = np.asarray(unwrap_to_reference(psi, t, ref))
    np.testing.assert_allclose(got, x, atol=1e-4)


def test_decode_spatial_frame_end_to_end():
    """Config-3 pipeline: fringes -> spatial unwrap -> depth, anchored by
    the true map; RMSE must be at the phase-noise floor."""
    import jax.numpy as jnp
    from slc_tpu import synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import SystemConfig
    from slc_tpu.pipeline import decode_spatial_frame

    cfg = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                       gray_bits=5)
    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
    period = 20.0
    imgs, z_gt, pu_gt = synth.render_fringe_stack(
        calib, cfg, synth.plane_surface(50.0, 0.05, 0.0),
        [period], 4, noise_sigma=1.0)
    res = decode_spatial_frame(
        jnp.asarray(imgs), tables, cfg, period,
        anchor=jnp.asarray(pu_gt, jnp.float32), unwrap_iters=500)
    z = np.asarray(res.z)
    valid = z > 0
    assert valid.mean() > 0.95
    rmse = np.sqrt(np.mean((z[valid] - z_gt[valid]) ** 2))
    assert rmse < 0.05


# ------------------------------------------------- hard scenes (round 2)
# VERDICT round 1, item 5: occlusion/discontinuity coverage, residue
# counting, CG convergence reporting, failure flagging.

def _box_step_scene(rng, t=32.0, h=96, w=128, step_periods=3.7,
                    noise=0.0):
    """A raised box over a ramped background: the fringe coordinate
    jumps ``step_periods * t`` across the box boundary — the canonical
    occlusion/depth-step scene. Returns (x_true, psi, box_mask,
    edge_ring) where edge_ring is the 2-px band around the boundary."""
    x = (np.linspace(0, 5 * t, w)[None, :]
         + 0.4 * np.arange(h)[:, None]).astype(np.float64)
    box = np.zeros((h, w), bool)
    box[h // 3: 2 * h // 3, w // 3: 2 * w // 3] = True
    x = x + step_periods * t * box
    psi = np.mod(x + (rng.normal(0, noise, (h, w)) if noise else 0.0),
                 t).astype(np.float32)
    inner = np.zeros_like(box)
    inner[h // 3 + 2: 2 * h // 3 - 2, w // 3 + 2: 2 * w // 3 - 2] = True
    outer = np.zeros_like(box)
    outer[h // 3 - 2: 2 * h // 3 + 2, w // 3 - 2: 2 * w // 3 + 2] = True
    edge_ring = outer & ~inner
    return x, psi, box, edge_ring


def test_unwrap_step_edge_masked_by_quality(rng):
    """The realistic case: the depth step casts a zero-modulation shadow
    (occlusion boundary), so its edges carry zero quality — the box is
    DISCONNECTED from the background. Both regions must unwrap exactly:
    the anchor fixes the box's free constant (any nonzero coupling
    would instead pull it to the wrapped — wrong — boundary gradient).
    Zero fringe-order errors outside the ring."""
    t = 32.0
    x, psi, box, ring = _box_step_scene(rng, t=t, noise=0.05)
    q = np.ones(psi.shape, np.float32)
    q[ring] = 0.0
    anchor = (x + rng.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    got, info = unwrap_spatial(jnp.asarray(psi), t,
                               quality=jnp.asarray(q), max_iters=800,
                               anchor=jnp.asarray(anchor),
                               return_info=True)
    got = np.asarray(got)
    good = ~ring
    order_err = np.abs(got[good] - x[good]) > t / 2
    assert order_err.mean() == 0.0, order_err.mean()
    # No high-quality edge was cut (the cut lives on the 0-weight ring)
    # and the solution stayed within an order of its anchor everywhere
    # outside the ring.
    assert int(info["suspect_count"]) == 0
    dis = np.asarray(info["anchor_disagreement"])
    assert dis[good].mean() == 0.0
    assert int(info["cg_iters"]) > 0
    assert float(info["rel_residual"]) < 1e-3


def test_unwrap_step_edge_unmasked_is_flagged(rng):
    """The ambiguous case: the same depth step with NO quality gate. A
    step of 3.7 periods leaves a wrapped-gradient error of exactly 4
    periods — self-consistent (zero residues, zero cut edges), so the
    LS solution silently shifts the whole box by -4 orders. That is
    fundamentally undetectable from psi alone; the ANCHOR disagreement
    diagnostic must flag the box, and the background must stay
    order-correct."""
    t = 32.0
    x, psi, box, ring = _box_step_scene(rng, t=t, noise=0.05)
    anchor = (x + rng.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    got, info = unwrap_spatial(jnp.asarray(psi), t, max_iters=800,
                               anchor=jnp.asarray(anchor),
                               return_info=True)
    got = np.asarray(got)
    # Background (outside box and ring) stays order-correct.
    bg = ~box & ~ring
    assert (np.abs(got[bg] - x[bg]) > t / 2).mean() < 0.02
    # The box interior IS wrong (shifted by an integer order)...
    inner = box & ~ring
    assert (np.abs(got[inner] - x[inner]) > t / 2).mean() > 0.9
    # ...and the anchor-disagreement mask flags it, not the background.
    dis = np.asarray(info["anchor_disagreement"])
    assert dis[inner].mean() > 0.8, dis[inner].mean()
    assert dis[bg].mean() < 0.05, dis[bg].mean()
    # The scene is self-consistent: the structural diagnostics are
    # (correctly) silent — this is exactly why the anchor one exists.
    assert int(info["residue_count"]) < 5
    assert float(np.asarray(info["suspect"])[bg].mean()) < 0.01


def test_residue_counting(rng):
    """Residues: a clean smooth ramp has none; heavy localized noise
    creates them and they are counted in info."""
    from slc_tpu.ops.unwrap_spatial import residues
    t = 32.0
    h, w = 64, 96
    x = np.linspace(0, 4 * t, w)[None, :] + 0.3 * np.arange(h)[:, None]
    psi_clean = np.mod(x, t).astype(np.float32)
    assert int(np.abs(np.asarray(residues(jnp.asarray(psi_clean), t)))
               .sum()) == 0
    psi_noisy = psi_clean.copy()
    psi_noisy[20:30, 30:60] = rng.uniform(0, t, (10, 30))
    n_res = int(np.abs(np.asarray(residues(jnp.asarray(psi_noisy), t)))
                .sum())
    assert n_res > 0
    _, info = unwrap_spatial(jnp.asarray(psi_noisy), t, max_iters=400,
                             return_info=True)
    assert int(info["residue_count"]) == n_res


def test_unwrap_iteration_cap_is_reported(rng):
    """When the CG cap cuts convergence short, rel_residual > tol tells
    the caller — no silent under-convergence."""
    t = 24.0
    h, w = 96, 128
    x = 30.0 + 40.0 * np.sin(np.linspace(0, 2, w))[None, :] \
        + 10.0 * np.cos(np.linspace(0, 3, h))[:, None]
    psi = np.mod(x, t).astype(np.float32)
    _, info = unwrap_spatial(jnp.asarray(psi), t, max_iters=3,
                             return_info=True)
    assert int(info["cg_iters"]) == 3
    assert float(info["rel_residual"]) > 1e-4


# --- multigrid preconditioner math (round 3) -------------------------

def _dense_laplacian(wy, wx):
    """Dense weighted graph Laplacian from edge-weight maps (numpy)."""
    h, w = wy.shape[0] + 1, wy.shape[1]
    n = h * w
    A = np.zeros((n, n))
    idx = lambda i, j: i * w + j
    for i in range(h - 1):
        for j in range(w):
            a, b, wt = idx(i, j), idx(i + 1, j), wy[i, j]
            A[a, a] += wt; A[b, b] += wt
            A[a, b] -= wt; A[b, a] -= wt
    for i in range(h):
        for j in range(w - 1):
            a, b, wt = idx(i, j), idx(i, j + 1), wx[i, j]
            A[a, a] += wt; A[b, b] += wt
            A[a, b] -= wt; A[b, a] -= wt
    return A


def test_coarsen_weights_is_exact_galerkin(rng):
    """A_c built by coarsen_weights must equal P^T A P for the 2x2
    piecewise-constant aggregation P — the property that makes the
    V-cycle's coarse correction exact, not approximate."""
    from slc_tpu.ops.unwrap_spatial import coarsen_weights
    h, w = 8, 12
    wy = rng.uniform(0.1, 1.0, (h - 1, w)).astype(np.float32)
    wx = rng.uniform(0.1, 1.0, (h, w - 1)).astype(np.float32)
    wy_c, wx_c = coarsen_weights(jnp.asarray(wy), jnp.asarray(wx), h, w)
    A = _dense_laplacian(wy, wx)
    hc, wc = h // 2, w // 2
    P = np.zeros((h * w, hc * wc))
    for i in range(h):
        for j in range(w):
            P[i * w + j, (i // 2) * wc + (j // 2)] = 1.0
    A_want = P.T @ A @ P
    A_got = _dense_laplacian(np.asarray(wy_c), np.asarray(wx_c))
    np.testing.assert_allclose(A_got, A_want, atol=1e-5)


def test_restrict_prolong_are_adjoint(rng):
    """<P e, r> == <e, P^T r>: restriction must be the exact transpose
    of prolongation (required for the preconditioner's symmetry)."""
    from slc_tpu.ops.unwrap_spatial import restrict2, prolong2
    h, w = 10, 14
    r = rng.normal(size=(h, w)).astype(np.float32)
    e = rng.normal(size=(h // 2, w // 2)).astype(np.float32)
    lhs = float(np.sum(np.asarray(prolong2(jnp.asarray(e), h, w)) * r))
    rhs = float(np.sum(e * np.asarray(restrict2(jnp.asarray(r)))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def _aggregation(h, w):
    """Dense 2x2 piecewise-constant aggregation P ((h*w, hc*wc)),
    ragged last row/column cells included."""
    hc, wc = -(-h // 2), -(-w // 2)
    p = np.zeros((h * w, hc * wc))
    for i in range(h):
        for j in range(w):
            p[i * w + j, (i // 2) * wc + (j // 2)] = 1.0
    return p


@pytest.mark.parametrize("shape", [(8, 12), (9, 12), (8, 13), (11, 7)])
def test_transfer_operators_match_aggregation(rng, shape):
    """The multigrid transfers against the dense aggregation P, on even
    and odd sizes: restrict2 == P^T, prolong2 == P, and coarsen_weights
    == P^T A P (the exact Galerkin operator)."""
    from slc_tpu.ops.unwrap_spatial import (restrict2, prolong2,
                                            coarsen_weights)
    h, w = shape
    hc, wc = -(-h // 2), -(-w // 2)
    p = _aggregation(h, w)
    r = rng.normal(size=(h, w)).astype(np.float32)
    e = rng.normal(size=(hc, wc)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(restrict2(jnp.asarray(r))).ravel(),
        p.T @ r.ravel(), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(prolong2(jnp.asarray(e), h, w)).ravel(),
        (p @ e.ravel()).astype(np.float32))
    wy = rng.uniform(0.1, 1.0, (h - 1, w)).astype(np.float32)
    wx = rng.uniform(0.1, 1.0, (h, w - 1)).astype(np.float32)
    wy_c, wx_c = coarsen_weights(jnp.asarray(wy), jnp.asarray(wx), h, w)
    assert wy_c.shape == (hc - 1, wc) and wx_c.shape == (hc, wc - 1)
    np.testing.assert_allclose(
        _dense_laplacian(np.asarray(wy_c), np.asarray(wx_c)),
        p.T @ _dense_laplacian(wy, wx) @ p, atol=1e-5)


def test_lane_pair_sum(rng):
    from slc_tpu.ops.unwrap_spatial import lane_pair_sum
    a = rng.normal(size=(5, 14)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(lane_pair_sum(jnp.asarray(a))),
                               a.reshape(5, 7, 2).sum(-1), atol=1e-6)


def test_vcycle_is_linear_and_symmetric(rng):
    """With kdepth=0 (plain V) the cycle must be a LINEAR operator in
    r and symmetric in the <.,.> inner product (equal pre/post
    smoothing, P/P^T transfers) — the classical SPD-preconditioner
    requirement. The default kdepth>0 K-cycle is deliberately mildly
    nonlinear (coarse Krylov steps) and is paired with the flexible
    PR+ outer CG instead; its effectiveness is covered by the
    iteration-count test below."""
    from slc_tpu.ops.unwrap_spatial import (build_mg_levels, vcycle,
                                            edge_weights)
    h, w = 40, 48
    q = rng.uniform(0.2, 1.0, (h, w)).astype(np.float32)
    wy, wx = edge_weights(jnp.asarray(q))
    levels = build_mg_levels(wy, wx, h, w, coarsest=16)
    assert len(levels) >= 2
    r1 = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    r2 = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    m = lambda r: vcycle(r, levels, kdepth=0)
    # Linearity.
    lin = np.asarray(m(2.5 * r1 - 0.5 * r2))
    np.testing.assert_allclose(lin,
                               2.5 * np.asarray(m(r1))
                               - 0.5 * np.asarray(m(r2)),
                               atol=1e-3)
    # Symmetry: <M r1, r2> == <r1, M r2>.
    a = float(jnp.sum(m(r1) * r2))
    b = float(jnp.sum(r1 * m(r2)))
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_kcycle_cuts_iteration_count(rng):
    """The K-cycle preconditioner (round 4) must converge the 2 MP-
    style multi-period scene in substantially fewer outer iterations
    than the plain V-cycle at the same tolerance — the level-count
    dependence of piecewise-constant aggregation is what it removes.
    Scaled-down scene (512x640, several coarse levels)."""
    from slc_tpu.ops.unwrap_spatial import unwrap_spatial

    h, w, t = 512, 640, 32.0
    x = (np.linspace(0, 12 * t, w)[None, :]
         + np.linspace(0, 2 * t, h)[:, None]).astype(np.float32)
    psi = np.mod(x, t).astype(np.float32)
    q = np.ones((h, w), np.float32)
    band = slice(h // 2, h // 2 + 8)
    psi[band] = rng.uniform(0, t, size=(8, w)).astype(np.float32)
    q[band] = 1e-3
    anchor = (x + rng.uniform(-t / 3, t / 3, size=x.shape)
              ).astype(np.float32)
    out, info = unwrap_spatial(jnp.asarray(psi), t,
                               quality=jnp.asarray(q),
                               anchor=jnp.asarray(anchor),
                               max_iters=300, tol=1e-4,
                               return_info=True)
    iters_k = int(info["cg_iters"])
    assert float(info["rel_residual"]) <= 1e-4
    # Correctness: interior good-quality pixels land on the truth.
    good = q > 0.5
    err = np.abs(np.asarray(out) - x)[good]
    assert np.median(err) < 1e-2
    # round-3 V(2,2) took ~60-90 iterations at this scale.
    assert iters_k <= 30, iters_k
