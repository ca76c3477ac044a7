"""Point clouds, normals, shaded preview renders, and ASCII export.

Vectorized re-design of the reference's point-cloud utilities
(DynaFrame/depthMapUtils.cpp) and result writer
(DynaFrame/CCalculation.cpp:323-357): per-pixel loops become dense
vectorized maps; the latent ``static`` min/max caching bug of the
reference normalizers (depthMapUtils.cpp:198-199,223-224,248-249 — the
first image's range poisons every later call) is deliberately NOT
reproduced.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("flip_xz",))
def depth_to_cloud(depth: jax.Array, fx: float, fy: float, cx: float,
                   cy: float, flip_xz: bool = False) -> jax.Array:
    """(H, W) depth -> (H, W, 3) camera-frame points via the pinhole
    model; depth == 0 marks invalid (depthMapUtils.cpp:5-39).

    ``flip_xz`` reproduces the reference's sign convention z' = -z,
    x' = -(j-cx) z'/fx (depthMapUtils.cpp:32-34); default is the plain
    camera frame used by the main pipeline (CCalculation.cpp:756-771).
    """
    h, w = depth.shape
    z = depth.astype(jnp.float32)
    u = jnp.arange(w, dtype=jnp.float32)[None, :] - jnp.float32(cx)
    v = jnp.arange(h, dtype=jnp.float32)[:, None] - jnp.float32(cy)
    if flip_xz:
        z = -z
        x = -u * z / fx
    else:
        x = u * z / fx
    y = v * z / fy
    return jnp.stack([x, y, z], axis=-1)


@jax.jit
def cloud_normals(cloud: jax.Array, valid: jax.Array
                  ) -> Tuple[jax.Array, jax.Array]:
    """Right/down-neighbor cross-product normals
    (depthMapUtils.cpp:96-121): n = (down - c) x (right - c), normalized.
    A pixel's normal is valid only if itself, its right and its down
    neighbor are valid; the last row/column are invalid. Returns
    (normals (H, W, 3), valid (H, W))."""
    right = jnp.roll(cloud, -1, axis=1)
    down = jnp.roll(cloud, -1, axis=0)
    n = jnp.cross(down - cloud, right - cloud)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-20)

    h, w = valid.shape
    v_right = jnp.roll(valid, -1, axis=1)
    v_down = jnp.roll(valid, -1, axis=0)
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    ok = (valid & v_right & v_down & (row < h - 1) & (col < w - 1))
    return jnp.where(ok[..., None], n, 0.0), ok


@jax.jit
def luminance_map(cloud: jax.Array, normals: jax.Array, valid: jax.Array,
                  camera_position=(1.0, 1.0, 1.0)) -> jax.Array:
    """Phong-style shaded preview (depthMapUtils.cpp:124-164): point
    light at the origin, ambient 60 / diffuse 150 / specular 50 with
    exponent 0.2, clamped to [0, 255], uint8; invalid pixels are 0."""
    i_amb, i_diff, i_spec, n_s = 60.0, 150.0, 50.0, 0.2
    cam = jnp.asarray(camera_position, jnp.float32)

    def unit(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True),
                               1e-20)

    ray = unit(-cloud)                                  # light at origin
    ndotr = jnp.sum(normals * ray, axis=-1)
    spec_ray = 2.0 * ndotr[..., None] * normals - ray
    view = unit(cam[None, None, :] - cloud)
    s = jnp.sum(view * spec_ray, axis=-1)
    intensity = (i_amb + i_diff * jnp.abs(ndotr)
                 + jnp.where(s > 0, i_spec * jnp.power(jnp.maximum(s, 1e-20),
                                                       n_s), 0.0))
    intensity = jnp.clip(intensity, 0.0, 255.0)
    return jnp.where(valid, intensity, 0.0).astype(jnp.uint8)


def render_depth_map(depth: jax.Array, fx: float, fy: float, cx: float,
                     cy: float) -> jax.Array:
    """Full preview render (depthMapUtils.cpp:167-187): bilateral-filter
    the depth for normal estimation, shade the RAW depth's cloud with the
    filtered normals."""
    from slc_tpu.ops.filters import bilateral_filter
    filtered = bilateral_filter(depth, radius=1, sigma_color=10.0,
                                sigma_space=25.0)
    f_cloud = depth_to_cloud(filtered, fx, fy, cx, cy)
    normals, ok = cloud_normals(f_cloud, filtered > 0)
    cloud = depth_to_cloud(depth, fx, fy, cx, cy)
    return luminance_map(cloud, normals, ok)


def normalize_to_u8(img: jax.Array) -> jax.Array:
    """Min-max normalize any image to uint8 for display — the fixed
    version of the reference normalizers (depthMapUtils.cpp:191-262),
    recomputing the range per call instead of caching it in statics."""
    x = jnp.asarray(img, jnp.float32)
    lo, hi = x.min(), x.max()
    y = (x - lo) / jnp.maximum(hi - lo, 1e-20) * 255.0
    return jnp.clip(y, 0.0, 255.0).astype(jnp.uint8)


# ----------------------------------------------------------------------
# Host-side ASCII export (CCalculation::Result, CCalculation.cpp:323-357,
# and the savePointCloud family, depthMapUtils.cpp:43-93).
# ----------------------------------------------------------------------

def write_xyz(path: str, x: np.ndarray, y: np.ndarray, z: np.ndarray,
              mask: Optional[np.ndarray] = None) -> int:
    """Write 'x y z' lines for valid pixels (z > 0 unless ``mask`` is
    given) — the per-frame output of the reference pipeline
    (CCalculation.cpp:341-350). Returns the number of points written.

    Uses the native C++ writer when available (the ~1.3M-point ASCII
    dump is host-format-bound; the reference pays this in iostream per
    frame, CCalculation.cpp:348-350)."""
    if mask is None:
        from slc_tpu.io import native
        l = native.lib()
        if l is not None:
            import ctypes
            fx, fy, fz = (np.ascontiguousarray(np.asarray(a, np.float32)
                                               ).ravel()
                          for a in (x, y, z))
            f32p = ctypes.POINTER(ctypes.c_float)
            n = l.slc_write_xyz(path.encode(),
                                fx.ctypes.data_as(f32p),
                                fy.ctypes.data_as(f32p),
                                fz.ctypes.data_as(f32p), fx.size)
            if n >= 0:
                return int(n)
    x, y, z = (np.asarray(a, np.float64).ravel() for a in (x, y, z))
    m = (z > 0) if mask is None else np.asarray(mask, bool).ravel()
    pts = np.stack([x[m], y[m], z[m]], axis=1)
    np.savetxt(path, pts, fmt="%.7f")
    return int(pts.shape[0])


def write_xyz_normals(path: str, cloud: np.ndarray, normals: np.ndarray,
                      valid: np.ndarray) -> int:
    """'x y z nx ny nz' export (depthMapUtils.cpp:43-60)."""
    c = np.asarray(cloud, np.float64).reshape(-1, 3)
    n = np.asarray(normals, np.float64).reshape(-1, 3)
    m = np.asarray(valid, bool).ravel()
    pts = np.concatenate([c[m], n[m]], axis=1)
    np.savetxt(path, pts, fmt="%.7f")
    return int(pts.shape[0])


def write_xyz_rgb(path: str, cloud: np.ndarray, valid: np.ndarray,
                  color: Optional[np.ndarray] = None) -> int:
    """'x y z r g b' export (depthMapUtils.cpp:62-93); grayscale colors
    are broadcast to r = g = b, absent colors to white."""
    c = np.asarray(cloud, np.float64).reshape(-1, 3)
    m = np.asarray(valid, bool).ravel()
    if color is None:
        rgb = np.full((c.shape[0], 3), 255, np.int64)
    else:
        col = np.asarray(color)
        if col.ndim == 2 or (col.ndim == 3 and col.shape[-1] == 1):
            col = np.repeat(col.reshape(-1, 1), 3, axis=1)
        else:
            col = col.reshape(-1, 3)
        rgb = col.astype(np.int64)
    with open(path, "w") as f:
        for p, q in zip(c[m], rgb[m]):
            f.write(f"{p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]} {q[1]} {q[2]}\n")
    return int(m.sum())


def write_cloud_npz(path: str, x: np.ndarray, y: np.ndarray,
                    z: np.ndarray) -> int:
    """Machine-readable per-frame cloud: float32 x/y/z maps with pixel
    indexing preserved (what the ASCII dump drops). ~40x faster to
    serialize than the reference-format 'x y z' text and the natural
    input for downstream fusion. Returns the valid-point count."""
    x, y, z = (np.asarray(a, np.float32) for a in (x, y, z))
    np.savez(path, x=x, y=y, z=z)
    return int((z > 0).sum())


class AsyncCloudWriter:
    """Background point-cloud writer: takes per-frame results off the
    reconstruction loop's critical path.

    The reference blocks its dynamic loop on an ASCII dump every frame
    (CCalculation::Result inside CalculateOther, CCalculation.cpp:
    310-315) — in our CPU replay runs the write leg *exceeded* the
    compute leg. ``submit`` starts the device->host copies
    asynchronously (they ride under the next frame's compute) and hands
    serialization to a writer thread; the loop only ever blocks if the
    bounded queue backs up (i.e. sustained write rate < frame rate).

    ``fmt``: "xyz" (reference-format ASCII via the native C++ writer)
    or "npz" (float32 maps, ~40x faster to serialize).
    """

    def __init__(self, fmt: str = "xyz", queue_depth: int = 4):
        import queue as _queue
        import threading
        if fmt not in ("xyz", "npz"):
            raise ValueError(f"unknown cloud format {fmt!r}")
        self.fmt = fmt
        self.frames = 0
        self.points = 0
        self.total_wall_s = 0.0
        self.errors: list = []
        self._q: "_queue.Queue" = _queue.Queue(maxsize=queue_depth)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def submit(self, path: str, x, y, z) -> None:
        """Enqueue one frame's maps for background serialization.

        INVARIANT (donation safety): the caller's tracker state is
        donated, so the *contents* of ``x``/``y``/``z`` must be pinned
        before the caller dispatches its next donated step. For JAX
        device arrays this method starts ``copy_to_host_async()``
        synchronously here — the D2H copy is ordered before any later
        dispatch can reuse the buffer. Anything else (numpy, lists,
        array-likes without the async-copy attribute) is materialized
        eagerly with ``np.asarray`` for the same reason: deferring the
        copy to the writer thread would race the donor (ADVICE r4).
        """
        pinned = []
        for a in (x, y, z):
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
                pinned.append(a)
            else:
                pinned.append(np.asarray(a))
        self._q.put((path, *pinned))

    def _run(self) -> None:
        import time
        while True:
            item = self._q.get()
            if item is None:
                return
            path, x, y, z = item
            t0 = time.perf_counter()
            try:
                x, y, z = (np.asarray(a) for a in (x, y, z))
                if self.fmt == "npz":
                    self.points += write_cloud_npz(path, x, y, z)
                else:
                    self.points += write_xyz(path, x, y, z)
                self.frames += 1
            except Exception as e:            # surfaced via close()
                self.errors.append(f"{path}: {e}")
            self.total_wall_s += time.perf_counter() - t0

    def close(self) -> dict:
        """Flush, join, and return a summary (also raises the first
        write error, if any — a silent lost frame is worse than a
        failed run)."""
        self._q.put(None)
        self._t.join()
        if self.errors:
            raise IOError("async cloud writes failed: "
                          + "; ".join(self.errors[:3]))
        return {"writer_frames": self.frames,
                "writer_points": self.points,
                "writer_total_ms": round(self.total_wall_s * 1e3, 3)}
