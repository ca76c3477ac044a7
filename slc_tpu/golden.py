"""Float64 NumPy golden oracle.

An independent, semantics-faithful re-implementation of the pipeline
math in host float64, used by the tests and chip_smoke.py to (a)
cross-check the JAX kernels against a second implementation and (b)
bound the float32 precision loss of the device path. Each function
documents the reference behavior it models (file:line into the
reference's DynaFrame sources).

This module intentionally contains zero JAX: plain numpy only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ----------------------------------------------------------------------
# Decoders
# ----------------------------------------------------------------------

def decode_phase(images: np.ndarray, period: float) -> np.ndarray:
    """4+-step phase decode (CDecodePhase.cpp:48-80), exact atan2."""
    n = images.shape[0]
    imgs = images.astype(np.float64)
    k = np.arange(n) * (2.0 * np.pi / n)
    sin_t = np.tensordot(np.cos(k), imgs, axes=(0, 0)) * (2.0 / n)
    cos_t = np.tensordot(np.sin(k), imgs, axes=(0, 0)) * (2.0 / n)
    ang = np.degrees(np.arctan2(sin_t, cos_t))
    ang = np.where(ang < 0, ang + 360.0, ang)
    pix = ang / 360.0 * period + 0.5          # CDecodePhase.cpp:69-70
    return np.where(pix > period, pix - period, pix)


def decode_gray(images: np.ndarray, num_bits: int,
                projector_extent: int) -> np.ndarray:
    """Gray decode via the explicit LUT route the reference takes
    (CDecodeGray.cpp:108-204), to independently validate the XOR-prefix
    closed form used on device."""
    lut = np.zeros(1 << num_bits, np.int64)
    for b in range(1 << num_bits):
        lut[b ^ (b >> 1)] = b                  # bin -> gray inverted
    gray = np.zeros(images.shape[1:], np.int64)
    for k in range(num_bits):
        bit = images[2 * k].astype(np.int32) > images[2 * k + 1].astype(np.int32)
        gray += bit.astype(np.int64) << k      # CDecodeGray.cpp:192-199
    period = projector_extent / (1 << num_bits)
    return lut[gray].astype(np.float64) * period


def modulation(images: np.ndarray) -> np.ndarray:
    """Fringe modulation amplitude |B| of an N-step stack (the validity
    signal of the framework's ``min_modulation`` masks)."""
    n = images.shape[0]
    imgs = images.astype(np.float64)
    k = np.arange(n) * (2.0 * np.pi / n)
    s = np.tensordot(np.cos(k), imgs, axes=(0, 0)) * (2.0 / n)
    c = np.tensordot(np.sin(k), imgs, axes=(0, 0)) * (2.0 / n)
    return np.hypot(s, c)


def heterodyne_unwrap(wrapped: np.ndarray, periods, extent: float
                      ) -> np.ndarray:
    """Multi-frequency beat unwrap, level by level: the pairwise beat of
    neighboring periods T_i*T_j/(T_j - T_i), cascaded until one phase
    spans ``extent``, then fringe-order rounding back down the left
    spine of the cascade to the finest period; wrapped into
    [0, extent)."""
    levels = [([w / p for w, p in zip(wrapped, periods)],
               [float(p) for p in periods])]
    while len(levels[-1][0]) > 1:
        fr, per = levels[-1]
        levels.append(([np.mod(fr[i] - fr[i + 1], 1.0)
                        for i in range(len(fr) - 1)],
                       [per[i] * per[i + 1] / abs(per[i + 1] - per[i])
                        for i in range(len(fr) - 1)]))
    x = levels[-1][0][0] * levels[-1][1][0]
    for fr, per in reversed(levels[:-1]):
        k = np.round(x / per[0] - fr[0])
        x = (k + fr[0]) * per[0]
    return np.mod(x, extent)


def gray_assisted_merge(gray_coord: np.ndarray, phase: np.ndarray,
                        gray_period: float, phase_period: float
                        ) -> np.ndarray:
    """Scalar-faithful merge (CCalculation.cpp:561-587)."""
    t = float(phase_period)
    ph = phase.copy()
    bin_idx = (gray_coord / gray_period).astype(np.int64)
    even = (bin_idx % 2) == 0
    ph = np.where(even & (ph > 0.75 * t), ph - t, ph)
    odd_ph = np.where(ph < 0.25 * t, ph + t, ph) - 0.5 * t
    ph = np.where(even, ph, odd_ph)
    return gray_coord + ph


# ----------------------------------------------------------------------
# Triangulation
# ----------------------------------------------------------------------

def triangulation_tables(cam_k: np.ndarray, pro_mat: np.ndarray,
                         cam_h: int, cam_w: int):
    """Unnormalized f64 tables exactly as the reference builds them
    (CCalculation.cpp:135-166)."""
    fx, fy = cam_k[0, 0], cam_k[1, 1]
    cx, cy = cam_k[0, 2], cam_k[1, 2]
    a = fx * fy * pro_mat[0, 3]
    b = fx * fy * pro_mat[2, 3]
    u = np.arange(cam_w, dtype=np.float64)[None, :] - cx
    v = np.arange(cam_h, dtype=np.float64)[:, None] - cy
    c = u * fy * pro_mat[0, 0] + v * fx * pro_mat[0, 1] + fx * fy * pro_mat[0, 2]
    d = u * fy * pro_mat[2, 0] + v * fx * pro_mat[2, 1] + fx * fy * pro_mat[2, 2]
    return a, b, np.broadcast_to(c, (cam_h, cam_w)), np.broadcast_to(d, (cam_h, cam_w))


def triangulate(proj_u: np.ndarray, cam_k: np.ndarray, pro_mat: np.ndarray,
                fov_min: float, fov_max: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """z = -(A - B P)/(C - D P), FOV clamp, back-projection
    (CCalculation.cpp:666-771); holes (P == 0) give z = 0."""
    h, w = proj_u.shape
    a, b, c, d = triangulation_tables(cam_k, pro_mat, h, w)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = -(a - b * proj_u) / (c - d * proj_u)
    z = np.where(proj_u == 0, 0.0, z)
    z = np.where((z < fov_min) | (z > fov_max), 0.0, z)
    u = np.arange(w, dtype=np.float64)[None, :] - cam_k[0, 2]
    v = np.arange(h, dtype=np.float64)[:, None] - cam_k[1, 2]
    x = z * u / cam_k[0, 0]
    y = z * v / cam_k[1, 1]
    return x, y, z


# ----------------------------------------------------------------------
# Dynamic tracking
# ----------------------------------------------------------------------

def box_sum_vertical(frame: np.ndarray, window: int) -> np.ndarray:
    """Literal rolling-DP transcription (CCalculation.cpp:797-823)."""
    r = window // 2
    h, w = frame.shape
    cam = frame.astype(np.float64)
    vs = np.zeros((h, w))
    for col in range(r, w - r):
        vs[r, col] = cam[0:window, col].sum()
    # Window rows [row - r, row - r + window): the row entering is
    # row - r + window - 1, which is row + r for the reference's odd
    # window and keeps the sum exact for even windows too.
    for row in range(r + 1, h - r):
        vs[row, r:w - r] = (vs[row - 1, r:w - r]
                            - cam[row - r - 1, r:w - r]
                            + cam[row - r + window - 1, r:w - r])
    return vs


def windowed_extrema(vs: np.ndarray, window: int, subpixel: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Scan transcription (CCalculation.cpp:828-891), including the
    strict-inequality/center-initialized tie-breaking: the offset loop
    runs in the reference's order, every interior pixel at once.

    ``subpixel`` adds the framework's parabolic refinement of each
    extremum through its two horizontal neighbors,
    offset += (v[-1] - v[+1]) / (2 (v[-1] - 2 v0 + v[+1])), clamped to
    +-0.5 and skipped where the curvature is below 1e-6."""
    r = window // 2
    h, w = vs.shape
    rows = np.arange(r, h - r)[:, None]
    cols = np.arange(r, w - r)[None, :]
    vmax = vs[rows, cols].copy()
    vmin = vmax.copy()
    imax = np.zeros_like(vmax)
    imin = np.zeros_like(vmax)
    for i in range(-r, r):
        val = vs[rows, cols + i]
        up = val > vmax
        vmax = np.where(up, val, vmax)
        imax = np.where(up, float(i), imax)
        dn = val < vmin
        vmin = np.where(dn, val, vmin)
        imin = np.where(dn, float(i), imin)
    if subpixel:
        def refine(idx, v0):
            at = cols + idx.astype(np.int64)
            vm = vs[rows, (at - 1) % w]
            vp = vs[rows, (at + 1) % w]
            den = vm - 2.0 * v0 + vp
            frac = np.where(np.abs(den) > 1e-6,
                            0.5 * (vm - vp) / np.where(den == 0, 1.0, den),
                            0.0)
            return idx + np.clip(frac, -0.5, 0.5)
        imax = refine(imax, vmax)
        imin = refine(imin, vmin)
    strip_w = np.zeros((h, w), np.float64)
    strip_b = np.zeros((h, w), np.float64)
    strip_w[r:h - r, r:w - r] = imax
    strip_b[r:h - r, r:w - r] = imin
    return strip_w, strip_b


def box_blur_3x3(x: np.ndarray) -> np.ndarray:
    """cv::blur(Size(3,3)) with BORDER_REFLECT_101 (CCalculation.cpp:650)."""
    p = np.pad(x.astype(np.float64), 1, mode="reflect")
    out = np.zeros_like(x, np.float64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out += p[1 + dy:1 + dy + x.shape[0], 1 + dx:1 + dx + x.shape[1]]
    return out / 9.0


def bilateral_filter(img: np.ndarray, radius: int = 1,
                     sigma_color: float = 10.0, sigma_space: float = 25.0,
                     hole_aware: bool = True) -> np.ndarray:
    """Brute-force bilateral filter (the depthMapUtils.cpp:179 call:
    d=3, sigmaColor=10, sigmaSpace=25) pixel by pixel: neighbors outside
    the image are missing, and with ``hole_aware`` zero pixels are
    missing too and stay zero."""
    x = img.astype(np.float64)
    h, w = x.shape
    out = np.zeros_like(x)
    for v in range(h):
        for u in range(w):
            if hole_aware and x[v, u] == 0:
                continue
            num = den = 0.0
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    vv, uu = v + dy, u + dx
                    if not (0 <= vv < h and 0 <= uu < w):
                        continue
                    n = x[vv, uu]
                    if hole_aware and n == 0:
                        continue
                    wgt = np.exp(-(n - x[v, u]) ** 2
                                 / (2 * sigma_color ** 2)
                                 - (dy * dy + dx * dx)
                                 / (2 * sigma_space ** 2))
                    num += wgt * n
                    den += wgt
            out[v, u] = num / den
    return out


def dynamic_step(proj_u_prev, strip_w_prev, strip_b_prev, frame, window):
    """One golden dynamic frame (CCalculation.cpp:221-242 body, minus
    triangulation): returns (proj_u, strip_w, strip_b, delta_p)."""
    vs = box_sum_vertical(frame, window)
    sw, sb = windowed_extrema(vs, window)
    db = strip_b_prev - sb
    dw = strip_w_prev - sw
    dp = np.where(np.abs(db) < np.abs(dw), db, dw)   # CCalculation.cpp:603-618
    dp = box_blur_3x3(dp)
    return proj_u_prev + dp, sw, sb, dp
