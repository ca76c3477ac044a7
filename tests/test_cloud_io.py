"""Point-cloud utilities and host I/O (BMP codec, OpenCV-YAML
calibration, replay dataset round trips)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from slc_tpu import cloud
from slc_tpu.calib import Calibration
from slc_tpu.io import (read_bmp, write_bmp, load_opencv_yaml,
                        save_calibration, load_calibration,
                        ReplayDataset, write_replay_dataset)

# The reference's example calibration (DynaFrame/Result.yml), regenerated
# from Calibration.reference_example()'s float64 values in its
# !!opencv-matrix schema.
REF_YML = os.path.join(os.path.dirname(__file__), "data", "Result.yml")


# ----------------------------------------------------------------- cloud

def test_depth_to_cloud_pinhole():
    z0, fx, fy, cx, cy = 50.0, 600.0, 600.0, 32.0, 24.0
    depth = np.full((48, 64), z0, np.float32)
    c = np.asarray(cloud.depth_to_cloud(jnp.asarray(depth), fx, fy, cx, cy))
    assert np.allclose(c[..., 2], z0)
    # Pixel (cy, cx) is on the optical axis.
    assert np.allclose(c[24, 32], [0.0, 0.0, z0])
    assert np.allclose(c[24, 33, 0], z0 / fx)


def test_depth_to_cloud_reference_sign_convention():
    """flip_xz reproduces depthMapUtils.cpp:32-34: z'=-z, x'=-(j-cx)z'/fx."""
    depth = np.full((8, 8), 10.0, np.float32)
    c = np.asarray(cloud.depth_to_cloud(jnp.asarray(depth), 100.0, 100.0,
                                        4.0, 4.0, flip_xz=True))
    assert np.allclose(c[..., 2], -10.0)
    assert np.allclose(c[4, 5, 0], -(5 - 4) * -10.0 / 100.0)


def test_cloud_normals_plane():
    """A z = const plane has normal -z with the right/down cross product
    (depthMapUtils.cpp:116: (down-c) x (right-c))."""
    depth = np.full((16, 16), 30.0, np.float32)
    c = cloud.depth_to_cloud(jnp.asarray(depth), 200.0, 200.0, 8.0, 8.0)
    n, ok = cloud.cloud_normals(c, jnp.asarray(depth) > 0)
    n, ok = np.asarray(n), np.asarray(ok)
    assert ok[:15, :15].all() and not ok[15].any() and not ok[:, 15].any()
    assert np.allclose(n[ok], [0.0, 0.0, -1.0], atol=1e-5)


def test_cloud_normals_invalid_propagation():
    depth = np.full((8, 8), 30.0, np.float32)
    depth[3, 4] = 0.0
    c = cloud.depth_to_cloud(jnp.asarray(depth), 100.0, 100.0, 4.0, 4.0)
    _, ok = cloud.cloud_normals(c, jnp.asarray(depth) > 0)
    ok = np.asarray(ok)
    # Itself plus the pixels whose right/down neighbor it is.
    assert not ok[3, 4] and not ok[3, 3] and not ok[2, 4]
    assert ok[3, 5] and ok[4, 4]


def test_luminance_map_range_and_holes():
    depth = np.full((32, 32), 40.0, np.float32)
    depth[:4] = 0.0
    c = cloud.depth_to_cloud(jnp.asarray(depth), 200.0, 200.0, 16.0, 16.0)
    n, ok = cloud.cloud_normals(c, jnp.asarray(depth) > 0)
    lum = np.asarray(cloud.luminance_map(c, n, ok))
    assert lum.dtype == np.uint8
    assert (lum[:4] == 0).all()
    valid = np.asarray(ok)
    # ambient 60 is the floor for any lit pixel (depthMapUtils.cpp:131).
    assert (lum[valid] >= 60).all()


def test_render_depth_map_runs():
    depth = np.full((32, 32), 40.0, np.float32)
    lum = np.asarray(cloud.render_depth_map(jnp.asarray(depth),
                                            200.0, 200.0, 16.0, 16.0))
    assert lum.shape == (32, 32) and lum.dtype == np.uint8
    assert (lum[:31, :31] >= 60).all()


def test_normalize_no_static_cache():
    """The reference's static min/max bug (depthMapUtils.cpp:198-199) must
    NOT be reproduced: each call uses its own range."""
    a = np.linspace(0, 100, 64, dtype=np.float32).reshape(8, 8)
    b = np.linspace(0, 1000, 64, dtype=np.float32).reshape(8, 8)
    na = np.asarray(cloud.normalize_to_u8(jnp.asarray(a)))
    nb = np.asarray(cloud.normalize_to_u8(jnp.asarray(b)))
    assert na.max() == 255 and nb.max() == 255
    assert na.min() == 0 and nb.min() == 0


def test_write_xyz(tmp_path):
    z = np.zeros((4, 4)); z[1:3, 1:3] = 5.0
    x = np.ones_like(z); y = 2 * np.ones_like(z)
    path = str(tmp_path / "c.txt")
    n = cloud.write_xyz(path, x, y, z)
    assert n == 4
    pts = np.loadtxt(path)
    assert pts.shape == (4, 3)
    assert np.allclose(pts[:, 2], 5.0)


def test_write_xyz_normals_and_rgb(tmp_path):
    c = np.random.default_rng(0).normal(size=(4, 4, 3))
    n = np.zeros((4, 4, 3)); n[..., 2] = 1.0
    valid = np.ones((4, 4), bool); valid[0] = False
    p1 = str(tmp_path / "n.txt")
    assert cloud.write_xyz_normals(p1, c, n, valid) == 12
    assert np.loadtxt(p1).shape == (12, 6)
    p2 = str(tmp_path / "rgb.txt")
    gray_img = np.full((4, 4), 128, np.uint8)
    assert cloud.write_xyz_rgb(p2, c, valid, gray_img) == 12
    data = np.loadtxt(p2)
    assert data.shape == (12, 6) and (data[:, 3:] == 128).all()


# -------------------------------------------------------------------- io

@pytest.mark.parametrize("shape", [(37, 53), (32, 64)])
def test_bmp_gray_roundtrip(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    p = str(tmp_path / "g.bmp")
    write_bmp(p, img)
    np.testing.assert_array_equal(read_bmp(p), img)


def test_bmp_color_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(21, 33, 3), dtype=np.uint8)
    p = str(tmp_path / "c.bmp")
    write_bmp(p, img)
    np.testing.assert_array_equal(read_bmp(p, grayscale=False), img)
    gray = read_bmp(p, grayscale=True)
    b, g, r = (img[..., i].astype(np.int32) for i in (2, 1, 0))
    want = ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)
    np.testing.assert_array_equal(gray, want)


def test_load_reference_yaml():
    """Parse the reference-schema calibration file (Result.yml:1-28)
    and check known values."""
    mats = load_opencv_yaml(REF_YML)
    assert set(mats) == {"CamMat", "ProMat", "R", "T"}
    assert mats["CamMat"].shape == (3, 3)
    assert abs(mats["CamMat"][0, 0] - 1213.8714552009253) < 1e-9
    assert mats["T"].shape == (3, 1)
    assert abs(mats["T"][2, 0] - 3.9430125669975382) < 1e-12
    # R is a rotation.
    r = mats["R"]
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-12)


def test_calibration_yaml_roundtrip(tmp_path):
    calib = Calibration.reference_example()
    p = str(tmp_path / "cal.yml")
    save_calibration(p, calib)
    loaded = load_calibration(p)
    np.testing.assert_allclose(np.asarray(loaded.cam_k),
                               np.asarray(calib.cam_k), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(loaded.rot),
                               np.asarray(calib.rot), rtol=1e-6)


def test_replay_dataset_roundtrip(tmp_path, rng):
    gray = rng.integers(0, 256, size=(10, 24, 32), dtype=np.uint8)
    phase = rng.integers(0, 256, size=(4, 24, 32), dtype=np.uint8)
    frames = rng.integers(0, 256, size=(5, 24, 32), dtype=np.uint8)
    root = str(tmp_path / "ds")
    write_replay_dataset(root, gray, phase, frames)

    ds = ReplayDataset(root, gray_count=10, phase_count=4)
    assert ds.frame_count == 5
    np.testing.assert_array_equal(ds.gray_images(), gray)
    np.testing.assert_array_equal(ds.phase_images(), phase)
    np.testing.assert_array_equal(ds.frame(3), frames[3])
    got = np.stack(list(ds.frames()))
    np.testing.assert_array_equal(got, frames)


# --------------------------------------------------------- visualization

def test_visualization_show_gated(tmp_path, monkeypatch):
    from slc_tpu import visualization as vis
    img = np.linspace(0, 1, 64).reshape(8, 8)
    monkeypatch.setattr(vis, "VISUAL_DEBUG", False)
    assert vis.show("x", img, out_dir=str(tmp_path)) is None
    p = vis.show("x", img, out_dir=str(tmp_path), force=True)
    assert p and os.path.exists(p)
    disp = read_bmp(p)
    assert disp.min() == 0 and disp.max() == 255


def test_store_images_batch(tmp_path, rng):
    from slc_tpu.visualization import store_images
    imgs = [rng.integers(0, 256, (16, 16), dtype=np.uint8)
            for _ in range(3)]
    d = str(tmp_path / "arch" / "nested")
    assert store_images(imgs, d, "img", start_idx=5) == 3
    for i in (5, 6, 7):
        np.testing.assert_array_equal(
            read_bmp(os.path.join(d, f"img{i}.bmp")), imgs[i - 5])


def test_resize_bilinear_zoom():
    from slc_tpu.visualization import resize_bilinear
    img = np.arange(64, dtype=np.float64).reshape(8, 8)
    # zoom 1.0 is identity (and the same object's values).
    np.testing.assert_array_equal(resize_bilinear(img, 1.0), img)
    # Integer upscale of a linear ramp stays a linear ramp: bilinear
    # interpolation reproduces linear functions exactly (interior).
    up = resize_bilinear(img, 2.0)
    assert up.shape == (16, 16)
    # Row gradient halves when the image doubles.
    interior = up[2:-2, 2:-2]
    d = np.diff(interior, axis=1)
    np.testing.assert_allclose(d, 0.5, atol=1e-12)
    # Downscale to half: shape floors like cv::Size(w*zoom, h*zoom).
    down = resize_bilinear(img, 0.5)
    assert down.shape == (4, 4)
    # uint8 round-trips through the integer clip path.
    u8 = resize_bilinear(img.astype(np.uint8), 2.0)
    assert u8.dtype == np.uint8 and u8.shape == (16, 16)


def test_normalize_depth_u16_exact():
    from slc_tpu.visualization import normalize_depth_u16
    d = np.array([[100, 200], [300, 400]], np.uint16)
    got = normalize_depth_u16(d)
    # Exact reference arithmetic: (v-min)/(max-min)*255, truncated
    # (depthMapUtils.cpp:204-209).
    want = ((d.astype(np.float64) - 100) / 300.0 * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    # No static min/max cache: a second call with a different range
    # re-normalizes (the reference bug at depthMapUtils.cpp:198-199).
    d2 = d + 1000
    np.testing.assert_array_equal(normalize_depth_u16(d2), want)
    flat = np.full((2, 2), 7, np.uint16)
    np.testing.assert_array_equal(normalize_depth_u16(flat),
                                  np.zeros((2, 2), np.uint8))


def test_normalize_f64_max_scale_quirk():
    from slc_tpu.visualization import normalize_f64
    # Ceiling is 0.01*max (normalize64FImage, depthMapUtils.cpp:249):
    # everything above it saturates at 255.
    d = np.array([[0.0, 1.0], [50.0, 100.0]])
    got = normalize_f64(d)
    assert got[0, 0] == 0
    assert got[0, 1] == 255  # 1.0 == 0.01*100 -> exactly the ceiling
    assert got[1, 0] == 255 and got[1, 1] == 255


def test_show_zoom(tmp_path):
    from slc_tpu import visualization as vis
    img = np.linspace(0, 255, 64).reshape(8, 8)
    p = vis.show("zoomed", img, out_dir=str(tmp_path), zoom=2.0,
                 force=True)
    assert read_bmp(p).shape == (16, 16)
