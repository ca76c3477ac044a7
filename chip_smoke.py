#!/usr/bin/env python3
"""Prove the structured-light pipeline on an NVIDIA GPU, in one process.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the tile-parallel and
                                   # landmark-sharded paths against the
                                   # single-device functions, nothing else

One-card phases, each printing one JSON line:

  device          the backend is a GPU; its kind, count, and the card's
                  name and power limit from nvidia-smi
  run_locked      CLI `synth` + `run` at the reference rig (1280x1024
                  camera, 1280x800 projector): Gray+phase frame 0, then
                  32 phase-locked dynamic frames
  run_heterodyne  CLI `synth --fringes` + `run --mode heterodyne`
  run_spatial     the same dataset through `run --mode spatial`
  step_parity     the 2 MP open-loop step and heterodyne decode against
                  the f64 oracle and the analytic plane
  fusion          16-scan bundle adjustment against ground-truth poses
                  and against the same solve on the host CPU
  gpu_tests       the card-only tests (pytest marker `gpu`), in-process

The CLI is called in-process (slc_tpu.__main__.main), never as a
subprocess: a second JAX process on the card fails for want of memory.
The last line is {"ok": true, "device": {...}} only if every phase
passed; otherwise the script exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def emit(rec):
    print(json.dumps(rec), flush=True)


def fail(msg, code):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return code


# ---------------------------------------------------------------------
# Sizes the phases run at: the reference rig, 2 MP, 16 scans.

SIZES = dict(cam="1024x1280", pro="800x1280", frames=33, fringe_frames=2,
             h2mp=1216, w2mp=1632, scans=16, landmarks=128)


# ---------------------------------------------------------------------
# Tolerances, each with its reason.

#: f32 decode vs the f64 oracle, per pixel (tests/test_decode.py:152).
PU_ATOL = 1e-3
#: f32 vs f64 depth where P agrees (tests/test_triangulate.py:54).
Z_ATOL = 5e-3
#: Pixels where f32 and f64 land on different sides of a fringe-order
#: rounding boundary differ by exactly one phase period. They must be
#: isolated and rare: at most this fraction of the frame (0 measured at
#: 640x480 on the CPU, tests/test_decode.py).
FLIP_FRAC = 1e-5
#: Accuracy against the analytic scene, set at ~3x the known-good levels
#: of .claude/skills/verify/SKILL.md (Gray+phase sphere RMSE 0.017 at
#: 640x480, heterodyne 2 MP plane RMSE 0.011, 100-frame phase-locked
#: drift 0.009 on the 96x160 rig, 16-scan BA ATE 0.011). Measured on an
#: H100 at the reference rig (deterministic for the seeded scenes):
#: frame-0 RMSE 0.030 and 32-frame drift 0.040, so the reference rig
#: sits above the small rigs and the drift bound has 1.25x headroom;
#: heterodyne 0.0075 (CLI) / 0.011 (2 MP), spatial 0.015, ATE 0.011.
FRAME0_RMSE = 0.05
DRIFT_MEDIAN = 0.05
HET_RMSE = 0.03
SPATIAL_RMSE = 0.05
MIN_VALID = 0.9
ATE = 0.03
#: Pose difference between the card's and the host CPU's solve of the
#: same BA problem: both run at "highest" matmul precision, so only the
#: summation order differs (the landmark-sharded solve matches the
#: single-device one to 3e-4). This bound does not detect TF32: a
#: control solve with the contractions left at TF32 moved the poses by
#: only 1.5e-5 from the host's on an H100 (PERF.md, "TF32"). The
#: explicit "highest" precision of the fusion path is what excludes it.
POSE_DELTA = 1e-3
#: The tiled unwrap sums its CG dot products as a psum of per-tile
#: partials, in another order than the single-device solve: the bound of
#: the CPU mesh test (tests/test_parallel.py). The tiled decodes and the
#: batched step compute every pixel from the same neighbours in the same
#: order and must be bit-identical, as the CPU mesh tests assert.
TILED_UNWRAP_ATOL = 1e-3


def order_flips(got, want, period):
    """Mask of pixels where f32 and f64 disagree beyond PU_ATOL; raises
    unless each is a whole-period flip and none form a 2x2 block."""
    d = np.asarray(got, np.float64) - want
    flip = np.abs(d) > PU_ATOL
    if flip.any():
        bad = np.abs(np.abs(d[flip]) - period) > 1e-2
        if bad.any():
            raise AssertionError(
                f"{int(bad.sum())} pixels differ by other than a whole "
                f"period; worst {float(np.abs(d).max())}")
        blk = flip[:-1, :-1] & flip[1:, :-1] & flip[:-1, 1:] & flip[1:, 1:]
        if blk.any():
            raise AssertionError("coherent block of order flips")
    return flip


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rmse_valid(z, z_gt, lit=None):
    """RMSE over pixels valid in both maps, and that set's share of the
    ``lit`` pixels (all pixels by default)."""
    lit = np.ones(z.shape, bool) if lit is None else lit
    v = (z > 0) & (z_gt > 0) & lit
    return (float(np.sqrt(np.mean((z[v] - z_gt[v]) ** 2))),
            float(v.sum() / lit.sum()))


def lit_by_projector(pu_gt, cfg):
    """Pixels whose analytic projector column lies on the projector. The
    reference rig's camera sees past the projector's right edge (~3% of
    the frame, measured); those pixels carry no pattern, decode to
    garbage in any implementation, and are left out of the accuracy
    checks."""
    return (pu_gt >= 0) & (pu_gt < cfg.pro_w)


# ---------------------------------------------------------------------
# Phases. Each writes its measurements into the record it is given,
# then checks them; a failed check raises.

def phase_device(rec, jax):
    dev = jax.devices()
    rec.update(platform=dev[0].platform, kind=dev[0].device_kind,
               count=len(dev))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise AssertionError(f"nvidia-smi failed: {e}")
    rec["nvidia_smi"] = smi.stdout.strip()
    check(smi.returncode == 0 and rec["nvidia_smi"], "nvidia-smi")
    # The card's name and power limit, as nvidia-smi gives them.
    print(rec["nvidia_smi"], flush=True)


def _cli(argv):
    from slc_tpu.__main__ import main
    with contextlib.redirect_stdout(sys.stderr):
        rc = main(argv)
    check(rc == 0, f"CLI {argv[0]} returned {rc}")


def _rig(ds):
    import dataclasses
    from slc_tpu.config import REFERENCE_CONFIG
    from slc_tpu.io.dataset import load_manifest
    from slc_tpu.io.opencv_yaml import load_calibration
    m = load_manifest(ds) or {}
    cfg = dataclasses.replace(REFERENCE_CONFIG, **{
        k: m[k] for k in ("cam_h", "cam_w", "pro_h", "pro_w", "gray_bits",
                          "phase_steps") if m.get(k) is not None})
    return cfg, load_calibration(os.path.join(ds, "parameters.yml"))


def phase_run_locked(rec, tmp, sz):
    import jax.numpy as jnp
    from slc_tpu import golden, synth
    from slc_tpu.__main__ import SYNTH_DZ
    from slc_tpu.calib import build_tables
    from slc_tpu.io.dataset import ReplayDataset
    from slc_tpu.pipeline import decode_first_frame

    ds, out = os.path.join(tmp, "locked"), os.path.join(tmp, "locked_out")
    n = sz["frames"]
    _cli(["synth", ds, "--frames", str(n), "--cam", sz["cam"],
          "--pro", sz["pro"]])
    _cli(["run", ds, "--calib", os.path.join(ds, "parameters.yml"),
          "--out", out, "--out-format", "npz", "--save-depth"])
    cfg, calib = _rig(ds)
    rec.update(cam=f"{cfg.cam_h}x{cfg.cam_w}",
               pro=f"{cfg.pro_h}x{cfg.pro_w}", frames=n,
               tolerances={"pu_atol": PU_ATOL, "z_atol": Z_ATOL,
                           "flip_frac": FLIP_FRAC, "rmse": FRAME0_RMSE,
                           "drift_median": DRIFT_MEDIAN,
                           "min_valid": MIN_VALID})

    # Frame-0 P on the card vs the f64 oracle, full frame.
    rds = ReplayDataset(ds, gray_count=2 * cfg.gray_bits,
                        phase_count=cfg.phase_steps)
    gray, phase = rds.gray_images(), rds.phase_images()
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
    res = decode_first_frame(jnp.asarray(gray), jnp.asarray(phase),
                             tables, cfg)
    pu64 = golden.gray_assisted_merge(
        golden.decode_gray(gray, cfg.gray_bits, cfg.pro_w),
        golden.decode_phase(phase, cfg.phase_period),
        cfg.gray_period, cfg.phase_period)
    flip = order_flips(res.proj_u, pu64, cfg.phase_period)
    rec["frame0_pu_flips"] = int(flip.sum())
    check(flip.mean() <= FLIP_FRAC, "order flips")
    ok = ~flip
    rec["frame0_pu_max_abs_diff"] = float(np.abs(
        np.asarray(res.proj_u, np.float64) - pu64)[ok].max())

    # The CLI's frame-0 depth vs f64 triangulation of the f64 P.
    z0 = np.load(os.path.join(out, "depth_iFrame.npz"))["z"]
    _, _, z64 = golden.triangulate(pu64, np.asarray(calib.cam_k,
                                                    np.float64),
                                   calib.pro_mat(), cfg.fov_min,
                                   cfg.fov_max)
    rec["frame0_z_max_abs_diff"] = float(np.abs(z0 - z64)[ok].max())
    check(rec["frame0_z_max_abs_diff"] <= Z_ATOL, "frame-0 z vs f64")

    # Depth vs the analytic scene: frame 0 and the last tracked frame.
    sphere = synth.sphere_surface()
    z_gt0, pu_gt0 = synth.surface_geometry(calib, cfg, sphere)
    lit = lit_by_projector(pu_gt0, cfg)
    rec["frame0_lit"] = float(lit.mean())
    rec["frame0_rmse"], rec["frame0_valid"] = rmse_valid(z0, z_gt0, lit)
    err = np.abs(z0 - z_gt0)[(z0 > 0) & (z_gt0 > 0) & lit]
    rec["frame0_abs_err_p50_p99_max"] = [float(np.median(err)),
                                         float(np.percentile(err, 99)),
                                         float(err.max())]
    check(rec["frame0_rmse"] <= FRAME0_RMSE, "frame-0 RMSE")
    last = n - 1
    z_last = np.load(os.path.join(out, f"cFrame{last}.npz"))["z"]
    z_gt, pu_gt = synth.surface_geometry(
        calib, cfg, synth.offset_surface(sphere, SYNTH_DZ * last))
    r = cfg.reco_window // 2 + 2
    inner = (slice(r, -r), slice(r, -r))
    zi, gi = z_last[inner], z_gt[inner]
    v = (zi > 0) & (gi > 0) & lit_by_projector(pu_gt, cfg)[inner]
    rec["terminal_drift_median"] = float(np.median(np.abs(zi[v] - gi[v])))
    rec["terminal_valid"] = float(v.mean())
    # The RMSE and the drift are taken over the pixels still valid: a
    # tracker that dropped most of them must not pass on the rest.
    check(rec["frame0_valid"] >= MIN_VALID, "frame-0 valid fraction")
    check(rec["terminal_valid"] >= MIN_VALID, "terminal valid fraction")
    check(rec["terminal_drift_median"] <= DRIFT_MEDIAN, "terminal drift")

    # metrics.jsonl: one record per frame, no fault record.
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    frames = sorted(x["frame"] for x in lines if "frame" in x)
    rec["metrics_frames"] = len(frames)
    check(frames == list(range(n)), f"metrics frames {frames[:3]}...")
    check(not any("fault" in x for x in lines), "fault record")
    check(any(x.get("period_diag") for x in lines), "lock not engaged")


def _fringe_dataset(tmp, sz):
    ds = os.path.join(tmp, "fringes")
    if not os.path.isdir(ds):
        _cli(["synth", ds, "--fringes", "--scene", "plane",
              "--frames", str(sz["fringe_frames"]), "--cam", sz["cam"],
              "--pro", sz["pro"]])
    return ds


def phase_run_heterodyne(rec, tmp, sz):
    from slc_tpu import synth
    ds = _fringe_dataset(tmp, sz)
    out = os.path.join(tmp, "het_out")
    _cli(["run", ds, "--calib", os.path.join(ds, "parameters.yml"),
          "--out", out, "--mode", "heterodyne", "--out-format", "npz"])
    cfg, calib = _rig(ds)
    z = np.load(os.path.join(out, "iFrame.npz"))["z"]
    z_gt, pu_gt = synth.surface_geometry(calib, cfg,
                                         synth.plane_surface(50.0))
    rec["tolerances"] = {"rmse": HET_RMSE, "min_valid": MIN_VALID}
    rec["rmse"], rec["valid"] = rmse_valid(z, z_gt,
                                           lit_by_projector(pu_gt, cfg))
    check(rec["valid"] >= MIN_VALID, "valid fraction")
    check(rec["rmse"] <= HET_RMSE, "RMSE")


def phase_run_spatial(rec, tmp, sz):
    """`run --mode spatial` on the fringe dataset, then the same decode
    (pipeline.decode_spatial_frame) called directly to read its P. The
    unanchored spatial unwrap is absolute only up to one global fringe
    order, which the CLI's depth cannot show (at this rig most orders
    put z outside the FOV clamp): P is checked against the analytic
    plane after removing its median whole-period offset."""
    import jax.numpy as jnp
    from slc_tpu import golden, synth
    from slc_tpu.calib import build_tables
    from slc_tpu.io.dataset import ReplayDataset
    from slc_tpu.pipeline import decode_spatial_frame
    ds = _fringe_dataset(tmp, sz)
    out = os.path.join(tmp, "spatial_out")
    _cli(["run", ds, "--calib", os.path.join(ds, "parameters.yml"),
          "--out", out, "--mode", "spatial", "--out-format", "npz"])
    cfg, calib = _rig(ds)
    rec["tolerances"] = {"rmse": SPATIAL_RMSE, "min_valid": MIN_VALID}
    rec["cli_depth_valid"] = float(
        (np.load(os.path.join(out, "iFrame.npz"))["z"] > 0).mean())
    phase = ReplayDataset(ds, gray_count=2 * cfg.gray_bits,
                          phase_count=cfg.phase_steps).phase_images()
    res = decode_spatial_frame(jnp.asarray(phase),
                               build_tables(calib, cfg.cam_h, cfg.cam_w),
                               cfg, float(cfg.phase_period))
    pu = np.asarray(res.proj_u, np.float64)
    _, pu_gt = synth.surface_geometry(calib, cfg, synth.plane_surface(50.0))
    lit = lit_by_projector(pu_gt, cfg)
    v = (pu != 0) & lit           # 0 is decode_spatial_frame's hole value
    rec["valid"] = float(v.sum() / lit.sum())
    k = int(np.round(np.median((pu[v] - pu_gt[v]) / cfg.phase_period)))
    rec["global_order"] = k
    _, _, z = golden.triangulate(np.where(v, pu - k * cfg.phase_period, 0),
                                 np.asarray(calib.cam_k, np.float64),
                                 calib.pro_mat(), cfg.fov_min, cfg.fov_max)
    z_gt, _ = synth.surface_geometry(calib, cfg, synth.plane_surface(50.0))
    rec["rmse"], _ = rmse_valid(z, z_gt, lit_by_projector(pu_gt, cfg))
    check(rec["valid"] >= MIN_VALID, "valid fraction")
    check(rec["rmse"] <= SPATIAL_RMSE, "RMSE")


def phase_step_parity(rec, sz):
    import jax.numpy as jnp
    from slc_tpu import golden, synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import SystemConfig, HeterodyneConfig
    from slc_tpu.dynamic import init_tracker, dynamic_step
    from slc_tpu.pipeline import decode_heterodyne_frame

    h, w = sz["h2mp"], sz["w2mp"]
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    tables = build_tables(calib, h, w)
    win = cfg.reco_window
    rec.update(shape=[h, w], tolerances={"pu_atol": PU_ATOL,
                                         "rmse": HET_RMSE,
                                         "min_valid": MIN_VALID})
    frames, z_gt, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, z0=50.0, dz_per_frame=0.05, stripe_period=12,
        noise_sigma=1.0)
    pu0 = np.asarray(pu_gt[0], np.float32)
    st = init_tracker(jnp.asarray(frames[0]), jnp.asarray(pu0),
                      jnp.asarray(z_gt[0], jnp.float32), cfg,
                      subpixel=False)
    gw0, gb0 = golden.windowed_extrema(
        golden.box_sum_vertical(frames[0], win), win)
    check(np.array_equal(np.asarray(st.strip_w), gw0)
          and np.array_equal(np.asarray(st.strip_b), gb0),
          "frame-0 stripe offsets vs f64")
    st1, res = dynamic_step(st, jnp.asarray(frames[1]), tables, cfg,
                            scale_gradient=False, subpixel=False,
                            robust=False)
    g_pu, g_sw, g_sb, _ = golden.dynamic_step(
        pu0.astype(np.float64), gw0, gb0, frames[1], win)
    check(np.array_equal(np.asarray(st1.strip_w), g_sw)
          and np.array_equal(np.asarray(st1.strip_b), g_sb),
          "stripe offsets vs f64")
    rec["step_pu_max_abs_diff"] = float(
        np.abs(np.asarray(res.proj_u) - g_pu).max())
    check(rec["step_pu_max_abs_diff"] <= PU_ATOL, "open-loop P vs f64")

    het = HeterodyneConfig()
    imgs, hz_gt, _ = synth.render_fringe_stack(
        calib, cfg, synth.plane_surface(55.0, 0.1, 0.05),
        het.periods(cfg.pro_w), het.phase_steps, noise_sigma=1.0)
    hres = decode_heterodyne_frame(jnp.asarray(imgs), tables, cfg, het)
    rec["heterodyne_rmse"], rec["heterodyne_valid"] = rmse_valid(
        np.asarray(hres.z), hz_gt)
    check(rec["heterodyne_rmse"] <= HET_RMSE, "heterodyne RMSE")
    check(rec["heterodyne_valid"] >= MIN_VALID, "heterodyne valid")


def phase_fusion(rec, jax, sz):
    from slc_tpu import fusion
    rng = np.random.default_rng(5)
    obs, mask, rot_gt, trans_gt = fusion.synthetic_problem(
        rng, s=sz["scans"], l=sz["landmarks"], noise=0.01)
    rot, trans, _ = fusion.fuse_scans(obs, mask, iters=10)
    ate = float(fusion.ate_rmse(rot, trans, rot_gt, trans_gt))
    cpu = jax.devices("cpu")[0]
    rot_c, trans_c, _ = fusion.fuse_scans(jax.device_put(obs, cpu),
                                          jax.device_put(mask, cpu),
                                          iters=10)
    delta = max(float(np.abs(np.asarray(rot) - np.asarray(rot_c)).max()),
                float(np.abs(np.asarray(trans)
                             - np.asarray(trans_c)).max()))
    rec.update(ate=ate, pose_delta_vs_host_cpu=delta,
               devices=sorted({d.platform for d in rot.devices()}),
               tolerances={"ate": ATE, "pose_delta": POSE_DELTA})
    check(ate <= ATE, "ATE")
    check(delta <= POSE_DELTA, "card vs host pose delta")


class _Outcomes:
    """pytest plugin: collects each test's outcome."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)


def phase_gpu_tests(rec):
    import pytest
    files = sorted(f for f in glob.glob(os.path.join(HERE, "tests",
                                                     "test_*.py"))
                   if "pytest.mark.gpu" in open(f).read())
    os.environ["SLC_TEST_GPU"] = "1"
    got = _Outcomes()
    with contextlib.redirect_stdout(sys.stderr):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-s", *files],
                         plugins=[got])
    rec.update(passed=got.passed, failed=got.failed, skipped=got.skipped)
    check(rc == 0 and got.passed and not got.failed and not got.skipped,
          f"pytest rc={rc}")


def phase_multi(rec, jax, sz):
    """Tile-parallel and landmark-sharded paths on a 2x2 tile mesh of
    four devices, against the single-device functions."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from slc_tpu import fusion, synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import SystemConfig, HeterodyneConfig
    from slc_tpu.dynamic import init_tracker, dynamic_step
    from slc_tpu.ops.unwrap_spatial import unwrap_spatial
    from slc_tpu.parallel import (tile_mesh, shard_image,
                                  tiled_absolute_decode,
                                  tiled_heterodyne_decode,
                                  tiled_batched_dynamic_step,
                                  tiled_unwrap_spatial)
    from slc_tpu.parallel.fusion_tiled import (fusion_mesh,
                                               shard_landmarks,
                                               tiled_fuse_scans)
    from slc_tpu.pipeline import decode_first_frame, decode_heterodyne_frame

    devs = jax.devices()
    check(len(devs) == 4, f"--multi needs 4 devices, found {len(devs)}")
    rec["tolerances"] = {"batched_step": "bit-identical",
                         "unwrap": TILED_UNWRAP_ATOL, "fusion": POSE_DELTA}

    def spread(name, *arrays):
        for a in arrays:
            n = len({s.device for s in a.addressable_shards})
            check(n == 4, f"{name}: output on {n} devices")

    def same(name, got, ref):
        check(np.array_equal(np.asarray(got), np.asarray(ref)),
              f"{name} not bit-identical")

    h, w = sz["h2mp"], sz["w2mp"]
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    tables = build_tables(calib, h, w)
    mesh = tile_mesh(devs)
    rec["mesh"] = dict(mesh.shape)

    scene = synth.render_static_scene(calib, cfg, synth.sphere_surface(),
                                      noise_sigma=1.0)
    g, p = jnp.asarray(scene.gray_images), jnp.asarray(scene.phase_images)
    ref = decode_first_frame(g, p, tables, cfg)
    got = tiled_absolute_decode(shard_image(g, mesh), shard_image(p, mesh),
                                tables, cfg, mesh)
    for f in ("proj_u", "z", "x", "y"):
        same(f"absolute {f}", getattr(got, f), getattr(ref, f))
    spread("absolute", got.proj_u, got.z)
    rec["absolute"] = "bit-identical"

    het = HeterodyneConfig()
    imgs, _, _ = synth.render_fringe_stack(
        calib, cfg, synth.plane_surface(55.0, 0.1, 0.05),
        het.periods(cfg.pro_w), het.phase_steps, noise_sigma=1.0)
    imgs = jnp.asarray(imgs)
    ref = decode_heterodyne_frame(imgs, tables, cfg, het)
    got = tiled_heterodyne_decode(shard_image(imgs, mesh), tables, cfg,
                                  het, mesh)
    for f in ("proj_u", "z", "x", "y"):
        same(f"heterodyne {f}", getattr(got, f), getattr(ref, f))
    spread("heterodyne", got.proj_u, got.z)
    rec["heterodyne"] = "bit-identical"

    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, 2, z0=50.0, dz_per_frame=0.05, stripe_period=12,
        noise_sigma=1.0)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), cfg)
    s3 = NamedSharding(mesh, P("scan", "ty", "tx"))
    states = jax.tree.map(
        lambda a: jax.device_put(a[None], s3) if a.ndim == 2 else a[None],
        state)
    fr = jnp.asarray(frames[1])
    new_states, got, metrics = tiled_batched_dynamic_step(
        states, jax.device_put(fr[None], s3), tables, cfg, mesh)
    _, ref = dynamic_step(state, fr, tables, cfg)
    d_pu = float(np.abs(np.asarray(got.proj_u)[0]
                        - np.asarray(ref.proj_u)).max())
    d_z = float(np.abs(np.asarray(got.z)[0] - np.asarray(ref.z)).max())
    spread("batched step", got.proj_u, new_states.proj_u)
    rec["batched_step"] = {"pu_max_abs_diff": d_pu, "z_max_abs_diff": d_z}
    check(d_pu == 0.0 and d_z == 0.0, "batched step not bit-identical")
    rec["batched_step"] = "bit-identical"

    t = 32.0
    r3 = np.random.default_rng(3)
    x = (np.linspace(0, 24 * t, w)[None, :]
         + np.linspace(0, 3 * t, h)[:, None]).astype(np.float32)
    psi = np.mod(x, t).astype(np.float32)
    q = np.ones((h, w), np.float32)
    band = slice(h // 2, h // 2 + 16)
    psi[band] = r3.uniform(0, t, size=(16, w)).astype(np.float32)
    q[band] = 1e-3
    anchor = (x + r3.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    ref = np.asarray(unwrap_spatial(jnp.asarray(psi), t,
                                    quality=jnp.asarray(q),
                                    anchor=jnp.asarray(anchor)))
    got = tiled_unwrap_spatial(
        shard_image(jnp.asarray(psi), mesh), t, mesh,
        quality=shard_image(jnp.asarray(q), mesh),
        anchor=shard_image(jnp.asarray(anchor), mesh))
    good = np.ones((h, w), bool)
    good[band] = False
    rec["unwrap_max_abs_diff"] = float(
        np.abs(np.asarray(got)[good] - ref[good]).max())
    check(rec["unwrap_max_abs_diff"] <= TILED_UNWRAP_ATOL, "tiled unwrap")
    spread("unwrap", got)

    rng = np.random.default_rng(5)
    obs, mask, _, _ = fusion.synthetic_problem(
        rng, s=sz["scans"], l=sz["landmarks"], noise=0.01)
    rot_s, trans_s, _ = fusion.fuse_scans(obs, mask, iters=10)
    fmesh = fusion_mesh(devs)
    obs_d, mask_d = shard_landmarks(fmesh, obs, mask)
    rot_d, trans_d, lm_d = tiled_fuse_scans(obs_d, mask_d, fmesh, iters=10)
    rec["fusion_pose_delta"] = max(
        float(np.abs(np.asarray(rot_d) - np.asarray(rot_s)).max()),
        float(np.abs(np.asarray(trans_d) - np.asarray(trans_s)).max()))
    check(rec["fusion_pose_delta"] <= POSE_DELTA, "sharded fusion")
    spread("fusion", rot_d, trans_d, lm_d)


# ---------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = set(argv) - {"--multi"}
    if unknown:
        return fail(f"unknown arguments {sorted(unknown)}", 2)
    multi, sz = "--multi" in argv, SIZES

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        return fail(f"no GPU: JAX's backend is {backend!r}", 2)
    try:
        from slc_tpu.compile_cache import enable_compile_cache
    except ImportError as e:
        return fail(f"the slc_tpu package is not importable: {e}", 3)
    enable_compile_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    phases = [("device", lambda r: phase_device(r, jax))]
    if multi:
        phases.append(("multi", lambda r: phase_multi(r, jax, sz)))
    else:
        phases += [
            ("run_locked", lambda r: phase_run_locked(r, tmp, sz)),
            ("run_heterodyne", lambda r: phase_run_heterodyne(r, tmp, sz)),
            ("run_spatial", lambda r: phase_run_spatial(r, tmp, sz)),
            ("step_parity", lambda r: phase_step_parity(r, sz)),
            ("fusion", lambda r: phase_fusion(r, jax, sz)),
            ("gpu_tests", phase_gpu_tests),
        ]
    failed = []
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            rec = {"phase": name, "ok": True}
            try:
                fn(rec)
            except Exception as e:
                traceback.print_exc()
                failed.append(name)
                rec.update(ok=False, error=f"{type(e).__name__}: {e}")
            rec["seconds"] = round(time.perf_counter() - t0, 3)
            emit(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        return fail(f"failed phases: {failed}", 1)
    dev = jax.devices()
    emit({"ok": True, "device": {"platform": dev[0].platform,
                                 "kind": dev[0].device_kind,
                                 "count": len(dev)}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
