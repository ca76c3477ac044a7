"""Command-line interface.

``python -m slc_tpu run``     — replay reconstruction (main.cpp:42-45)
``python -m slc_tpu synth``   — render a synthetic replay dataset
``python -m slc_tpu capture`` — acquire a dataset via the project->
                                capture loop (live-mode workflow)
``python -m slc_tpu fuse``    — register multiple scans into one cloud
``python -m slc_tpu bench``   — the repo benchmark (delegates to bench.py)
"""

from __future__ import annotations

import argparse
import sys

# The moving scene `synth` renders: the frame-0 surface shifted along +z
# by SYNTH_DZ per dynamic frame, lit by a stripe of SYNTH_STRIPE_PERIOD
# projector px (recorded in the manifest for phase-locked tracking).
SYNTH_DZ = 0.08
SYNTH_STRIPE_PERIOD = 12


def _add_cfg_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cam", default=None,
                   help="camera resolution HxW (default: reference "
                        "1024x1280, StaticParameters.cpp:8-9)")
    p.add_argument("--pro", default=None, help="projector resolution HxW")
    p.add_argument("--gray-bits", type=int, default=None)
    p.add_argument("--phase-steps", type=int, default=None)


def _explicit_cfg_updates(args) -> dict:
    updates = {}
    if args.cam:
        h, w = (int(v) for v in args.cam.split("x"))
        updates.update(cam_h=h, cam_w=w)
    if args.pro:
        h, w = (int(v) for v in args.pro.split("x"))
        updates.update(pro_h=h, pro_w=w)
    if args.gray_bits is not None:
        updates.update(gray_bits=args.gray_bits)
    if args.phase_steps is not None:
        updates.update(phase_steps=args.phase_steps)
    return updates


def _build_cfg(args, manifest=None):
    """REFERENCE_CONFIG <- dataset manifest <- explicit flags, with a
    clear error when a flag contradicts what the dataset records."""
    import dataclasses
    from slc_tpu.config import REFERENCE_CONFIG
    from_manifest = {}
    if manifest:
        for key in ("cam_h", "cam_w", "pro_h", "pro_w", "gray_bits",
                    "phase_steps"):
            if manifest.get(key) is not None:
                from_manifest[key] = manifest[key]
    explicit = _explicit_cfg_updates(args)
    for k, v in explicit.items():
        if k in from_manifest and from_manifest[k] != v:
            raise SystemExit(
                f"--{k.replace('_', '-')}={v} conflicts with the dataset "
                f"manifest ({k}={from_manifest[k]}); drop the flag or "
                f"regenerate the dataset")
    updates = {**from_manifest, **explicit}
    return (dataclasses.replace(REFERENCE_CONFIG, **updates)
            if updates else REFERENCE_CONFIG)


def _cmd_capture(args, cfg) -> int:
    """Acquisition workflow (the reference's not-compiled live mode,
    CCamera.cpp:94-118 / CProjector.cpp:46-76 / main.cpp:50-76): drive
    a Sensor through the synchronous project->capture loop over the
    frame-0 pattern budget (+ per-frame stripe captures of a moving
    plane) and write the result as a standard replay dataset. The
    built-in sensor is the analytic SimulatedRig; real hardware is a
    `capture.Sensor` protocol implementation."""
    import os

    import numpy as np

    from slc_tpu import patterns, synth
    from slc_tpu.calib import synthetic_calibration
    from slc_tpu.capture import (SimulatedRig, capture_sequence,
                                 structured_light_patterns)
    from slc_tpu.io.dataset import write_replay_dataset
    from slc_tpu.io.opencv_yaml import save_calibration

    calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                  pro_h=cfg.pro_h, pro_w=cfg.pro_w)
    z0, dz = 50.0, 0.08
    surface = (synth.sphere_surface() if args.scene == "sphere"
               else synth.plane_surface(z0))
    rig = SimulatedRig(calib, cfg, surface, noise_sigma=args.noise)
    imgs = capture_sequence(rig, structured_light_patterns(cfg))
    gray = np.stack(imgs[:2 * cfg.gray_bits])
    phase = np.stack(imgs[2 * cfg.gray_bits:])

    frames = None
    if args.frames:
        stripe = patterns.stripe_pattern(cfg.pro_w, cfg.pro_h,
                                         args.stripe_period)
        caps = []
        for f in range(args.frames):
            # The dynamic sequence must MOVE THE DECODED SCENE: the
            # tracker is initialized from the frame-0 absolute map, so
            # a dynamic geometry unrelated to it (the old always-a-
            # plane behavior under --scene sphere) made every CLI
            # sphere dataset internally inconsistent — tracking
            # started T/2+ away from truth and silently never
            # recovered (found via the round-5 period diagnostic).
            rig_f = SimulatedRig(calib, cfg,
                                 synth.offset_surface(surface, dz * f),
                                 noise_sigma=args.noise, seed=f + 1)
            caps.extend(capture_sequence(rig_f, [stripe]))
        frames = np.stack(caps)

    write_replay_dataset(args.out, gray, phase, frames,
                         config_fields={
                             "pro_h": cfg.pro_h, "pro_w": cfg.pro_w,
                             "gray_bits": cfg.gray_bits,
                             "phase_steps": cfg.phase_steps,
                             "scene": args.scene,
                             "noise_sigma": args.noise,
                             "captured": True,
                             "stripe_period": args.stripe_period,
                         })
    os.makedirs(args.out, exist_ok=True)
    save_calibration(os.path.join(args.out, "parameters.yml"), calib)
    print(f"captured dataset -> {args.out} ({len(gray)} gray + "
          f"{len(phase)} phase + {args.frames} dynamic frames)")
    return 0


def _cmd_fuse(args) -> int:
    """Multi-scan registration CLI (BASELINE config 5 as a user flow):
    load per-scan depth maps, jointly register them with alternating
    projective association + point-to-plane Schur BA
    (slc_tpu.fusion_frontend.register_scans), and write the poses plus
    one fused world-frame cloud."""
    import json
    import os

    import numpy as np
    import jax.numpy as jnp

    from slc_tpu import cloud
    from slc_tpu.fusion_frontend import register_scans

    if len(args.depths) < 2:
        raise SystemExit("fuse needs at least 2 depth_iFrame.npz files")
    zs, cam_k = [], None
    for p in args.depths:
        d = np.load(p)
        if "z" not in d or "cam_k" not in d:
            raise SystemExit(f"{p} is not a depth_iFrame.npz "
                             "(expected arrays 'z' and 'cam_k')")
        if cam_k is None:
            cam_k = d["cam_k"]
        elif not np.allclose(cam_k, d["cam_k"]):
            raise SystemExit(f"{p} has a different cam_k: scans must "
                             "come from the same rig")
        if zs and d["z"].shape != zs[0].shape:
            raise SystemExit(f"{p} depth shape {d['z'].shape} != "
                             f"{zs[0].shape}")
        zs.append(d["z"].astype(np.float32))
    depths = np.stack(zs)
    s = len(zs)
    init_rot = np.tile(np.eye(3, dtype=np.float32), (s, 1, 1))
    init_trans = np.zeros((s, 3), np.float32)
    rot, trans = register_scans(
        jnp.asarray(depths), jnp.asarray(cam_k), jnp.asarray(init_rot),
        jnp.asarray(init_trans), rounds=args.rounds,
        gn_iters=args.gn_iters, grid_step=args.grid_step,
        max_depth_err=args.max_depth_err)
    rot = np.asarray(rot)
    trans = np.asarray(trans)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "poses.json"), "w") as f:
        json.dump({"scans": args.depths,
                   "world_from_scan": [
                       {"rot": rot[i].tolist(),
                        "trans": trans[i].tolist()} for i in range(s)]},
                  f, indent=1)

    fx, fy = float(cam_k[0, 0]), float(cam_k[1, 1])
    cx, cy = float(cam_k[0, 2]), float(cam_k[1, 2])
    xs, ys, zw, valid = [], [], [], []
    for i in range(s):
        pts = np.asarray(cloud.depth_to_cloud(jnp.asarray(depths[i]),
                                              fx, fy, cx, cy))
        world = pts.reshape(-1, 3) @ rot[i].T + trans[i]
        xs.append(world[:, 0])
        ys.append(world[:, 1])
        zw.append(world[:, 2])
        valid.append(depths[i].reshape(-1) > 0)
    n = cloud.write_xyz(os.path.join(args.out, "fused.txt"),
                        np.concatenate(xs), np.concatenate(ys),
                        np.concatenate(zw),
                        mask=np.concatenate(valid))
    print(f"fused {s} scans -> {args.out}/fused.txt ({n} points), "
          f"poses.json")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slc_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="replay reconstruction")
    runp.add_argument("dataset", help="dataset root (iFrame/, cFrame/)")
    runp.add_argument("--calib", required=True,
                      help="OpenCV-YAML calibration (CamMat/ProMat/R/T)")
    runp.add_argument("--out", default="out")
    runp.add_argument("--max-frames", type=int, default=None)
    runp.add_argument("--no-clouds", action="store_true")
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--resume", action="store_true")
    runp.add_argument("--reference-semantics", action="store_true",
                      help="disable subpixel tracking, gradient scaling "
                           "and the robust deltaP combine (exact "
                           "CCalculation.cpp:595-660 behavior)")
    runp.add_argument("--mode", choices=["gray", "heterodyne", "spatial"],
                      default="gray",
                      help="frame-0 absolute decode method")
    runp.add_argument("--save-depth", action="store_true",
                      help="also write depth_iFrame.npz (z + cam_k) "
                           "for downstream `fuse`")
    runp.add_argument("--preview", action="store_true",
                      help="write shaded depth preview BMPs (frame 0 "
                           "and the final frame)")
    runp.add_argument("--phase-lock", default="auto",
                      help="'auto' (default: lock to the manifest's "
                           "stripe_period), 'off', or an explicit "
                           "stripe period in projector px — snap the "
                           "integrated P to the per-frame wrapped "
                           "carrier phase (kills deltaP-integration "
                           "drift)")
    runp.add_argument("--refine-period", action="store_true",
                      help="adopt the carrier period measured from the "
                           "first dynamic frame instead of the "
                           "configured one (the runner always logs "
                           "the measurement and warns at > 1% "
                           "deviation; adopt when the configured "
                           "period is suspect)")
    runp.add_argument("--out-format", choices=["xyz", "npz"],
                      default="xyz",
                      help="per-frame cloud format: reference-format "
                           "ASCII or float32 npz maps (~40x faster)")
    runp.add_argument("--chunk", type=int, default=1,
                      help="scan K consecutive frames per device "
                           "dispatch (amortizes per-frame dispatch "
                           "cost; fault/anchor/checkpoint semantics "
                           "preserved)")
    runp.add_argument("--strict-loop", action="store_true",
                      help="reference-style synchronous read->step->"
                           "write loop instead of the streaming "
                           "prefetch + background-writer path")
    _add_cfg_args(runp)

    sy = sub.add_parser("synth", help="render a synthetic replay dataset")
    sy.add_argument("out", help="dataset root to create")
    sy.add_argument("--frames", type=int, default=8)
    sy.add_argument("--noise", type=float, default=1.0)
    sy.add_argument("--scene", choices=["plane", "sphere"], default="sphere")
    sy.add_argument("--fringes", action="store_true",
                    help="also write the multi-frequency fringe stack "
                         "for --mode heterodyne")
    sy.add_argument("--anchor-every", type=int, default=0,
                    help="write absolute re-anchoring pattern groups "
                         "(aFrame{f}/) every K dynamic frames; requires "
                         "--scene plane")
    _add_cfg_args(sy)

    cap = sub.add_parser(
        "capture", help="acquire a replay dataset through the "
                        "project->capture loop (live-mode workflow, "
                        "CCamera/CProjector roles; simulated rig here)")
    cap.add_argument("out", help="dataset root to create")
    cap.add_argument("--scene", choices=["plane", "sphere"],
                     default="sphere")
    cap.add_argument("--frames", type=int, default=0,
                     help="dynamic frames to capture (moving plane "
                          "lit by the single stripe pattern)")
    cap.add_argument("--noise", type=float, default=1.0,
                     help="sensor read-noise sigma (gray levels)")
    cap.add_argument("--stripe-period", type=int, default=12)
    _add_cfg_args(cap)

    fu = sub.add_parser(
        "fuse", help="register multiple scans into one fused cloud "
                     "(multi-scan Schur-complement bundle adjustment)")
    fu.add_argument("depths", nargs="+",
                    help="depth_iFrame.npz files from `run --save-depth`"
                         " (>=2, same rig)")
    fu.add_argument("--out", default="fused",
                    help="output dir: poses.json + fused.txt")
    fu.add_argument("--rounds", type=int, default=4,
                    help="association<->BA alternations")
    fu.add_argument("--gn-iters", type=int, default=5)
    fu.add_argument("--grid-step", type=int, default=8,
                    help="landmark sampling stride (px)")
    fu.add_argument("--max-depth-err", type=float, default=1.0,
                    help="projective-association gate (scene units)")

    sub.add_parser("bench", help="run the repo benchmark")

    args = ap.parse_args(argv)

    if args.cmd == "fuse":
        return _cmd_fuse(args)

    if args.cmd == "bench":
        sys.path.insert(0, ".")
        import bench
        return bench.main()

    manifest = None
    if args.cmd == "run":
        from slc_tpu.io.dataset import load_manifest
        manifest = load_manifest(args.dataset)
    cfg = _build_cfg(args, manifest)

    if args.cmd == "synth":
        import numpy as np
        from slc_tpu import synth
        from slc_tpu.calib import synthetic_calibration
        from slc_tpu.io.dataset import write_replay_dataset
        from slc_tpu.io.opencv_yaml import save_calibration
        import os
        calib = synthetic_calibration(cam_h=cfg.cam_h, cam_w=cfg.cam_w,
                                      pro_h=cfg.pro_h, pro_w=cfg.pro_w)
        surface = (synth.sphere_surface() if args.scene == "sphere"
                   else synth.plane_surface(50.0))
        scene = synth.render_static_scene(calib, cfg, surface,
                                          noise_sigma=args.noise)
        fringes = None
        if args.fringes:
            from slc_tpu.config import HeterodyneConfig
            het = HeterodyneConfig(phase_steps=cfg.phase_steps)
            fringes, _, _ = synth.render_fringe_stack(
                calib, cfg, surface, het.periods(cfg.pro_w),
                het.phase_steps, noise_sigma=args.noise)
        frames = None
        z0, dz = 50.0, SYNTH_DZ
        stripe_period = SYNTH_STRIPE_PERIOD
        if args.frames:
            # Move the DECODED scene along +z (see the capture CLI
            # comment): for --scene plane this reproduces the old
            # moving plane exactly; for sphere the sphere now moves,
            # keeping frame 0 consistent with the absolute decode.
            frames, _, _ = synth.render_dynamic_sequence(
                calib, cfg, args.frames, z0=z0, dz_per_frame=dz,
                stripe_period=stripe_period, noise_sigma=args.noise,
                surface_for_frame=(
                    lambda f: synth.offset_surface(surface, dz * f)))
        write_replay_dataset(args.out, scene.gray_images,
                             scene.phase_images, frames, fringes,
                             config_fields={
                                 "pro_h": cfg.pro_h, "pro_w": cfg.pro_w,
                                 "gray_bits": cfg.gray_bits,
                                 "phase_steps": cfg.phase_steps,
                                 "scene": args.scene,
                                 "noise_sigma": args.noise,
                                 "anchor_every": args.anchor_every,
                                 "stripe_period": stripe_period,
                             })
        if args.anchor_every:
            from slc_tpu.io.dataset import write_anchor_group
            for f in range(args.anchor_every, args.frames,
                           args.anchor_every):
                asc = synth.render_static_scene(
                    calib, cfg, synth.offset_surface(surface, f * dz),
                    noise_sigma=args.noise, seed=f + 1)
                write_anchor_group(args.out, f, asc.gray_images,
                                   asc.phase_images)
        os.makedirs(args.out, exist_ok=True)
        save_calibration(os.path.join(args.out, "parameters.yml"), calib)
        print(f"wrote dataset to {args.out} "
              f"({2 * cfg.gray_bits} gray + {cfg.phase_steps} phase + "
              f"{args.frames} dynamic frames, calib parameters.yml)")
        return 0

    if args.cmd == "capture":
        return _cmd_capture(args, cfg)

    if args.cmd == "run":
        from slc_tpu.runner import run_replay
        ref = args.reference_semantics
        if args.phase_lock in ("auto", "off"):
            lock = None if args.phase_lock == "off" else "auto"
        else:
            lock = float(args.phase_lock)
        report = run_replay(
            args.dataset, args.calib, args.out, cfg,
            max_frames=args.max_frames, write_clouds=not args.no_clouds,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            scale_gradient=not ref, subpixel=not ref, robust=not ref,
            mode=args.mode,
            save_depth=args.save_depth, preview=args.preview,
            phase_lock=None if ref else lock,
            refine_period=args.refine_period,
            out_format=args.out_format, stream=not args.strict_loop,
            chunk=args.chunk)
        last = report.metrics.records[-1] if report.metrics.records else {}
        print(f"done: frames={report.frames_done} "
              f"first_frame_points={report.first_frame_points} "
              f"last_valid_frac={last.get('valid_frac', 0):.3f}")
        return 0

    return 1


def cli() -> int:
    """Process entry point: set up the compile cache, then run
    :func:`main` (which in-process callers use directly)."""
    from slc_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    return main()


if __name__ == "__main__":
    raise SystemExit(cli())
