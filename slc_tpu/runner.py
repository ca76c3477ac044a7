"""End-to-end reconstruction runner — the main.cpp equivalent.

The reference program is ``Init -> CalculateFirst -> CalculateOther``
over a replay dataset, writing one ASCII point cloud per frame
(DynaFrame/main.cpp:42-45, CCalculation.cpp:77-357). ``run_replay``
reproduces that flow on top of the functional pipeline, adding what the
reference lacks (SURVEY.md §5): structured per-frame metrics, periodic
checkpointing with resume, and I/O prefetch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from slc_tpu import cloud
from slc_tpu.calib import Calibration, build_tables
from slc_tpu.checkpoint import save_state, load_state, latest_checkpoint
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import init_tracker, dynamic_step, reanchor
from slc_tpu.io.dataset import ReplayDataset
from slc_tpu.io.opencv_yaml import load_calibration
from slc_tpu.metrics import MetricsLog, frame_stats, stage
from slc_tpu.pipeline import (FrameResult, decode_first_frame,
                              decode_heterodyne_frame,
                              decode_spatial_frame)


@dataclasses.dataclass
class RunReport:
    frames_done: int
    first_frame_points: int
    metrics: MetricsLog


def run_replay(dataset_root: str, calib: "Calibration | str",
               out_dir: str, cfg: SystemConfig,
               max_frames: Optional[int] = None,
               write_clouds: bool = True,
               checkpoint_every: int = 0,
               resume: bool = False,
               scale_gradient: bool = True,
               subpixel: bool = True,
               robust: bool = True,
               fault_drop_prob: float = 0.0,
               fault_corrupt_prob: float = 0.0,
               fault_seed: int = 0,
               mode: str = "gray",
               use_anchors: bool = True,
               save_depth: bool = False,
               preview: bool = False,
               phase_lock: "str | float | None" = "auto",
               lock_window: Optional[int] = None,
               refine_period: bool = False,
               out_format: str = "xyz",
               stream: bool = True,
               chunk: int = 1) -> RunReport:
    """Run the full reference pipeline over a replay dataset.

    ``mode`` selects the frame-0 absolute decode: "gray" (the
    reference's Gray+phase path), "heterodyne" (BASELINE config 2,
    reads the vFringeCam stack), or "spatial" (config 3: single
    frequency + quality-guided spatial unwrap of the vPhaseCam stack).
    The dynamic tracking loop is identical in every mode.

    ``phase_lock``: "auto" (default) snaps the integrated P to the
    wrapped stripe-carrier phase of every dynamic frame
    (slc_tpu.ops.demod) when the dataset manifest records its
    ``stripe_period``; a float forces that period; None disables.
    ``lock_window`` overrides the demod window (default: suggested
    from the frame-0 absolute map).

    When the lock is enabled the runner ALWAYS measures the carrier
    period from the first dynamic frame against the frame-0 absolute
    map (``demod.estimate_period``) and logs it; a deviation > 1%
    from the configured period is warned about (the carrier-
    consistency gate would zero every correction at >= ~2%).
    ``refine_period=True`` additionally ADOPTS the estimate — opt-in
    because the estimator carries the demod's own ~0.2% chirp bias,
    which on short, slow sequences can cost more static z bias than
    open-loop drift would; it is the right call whenever the
    configured period is suspect (estimator accuracy holds from a
    +-10% wrong nominal).

    ``stream`` (default): dynamic frames arrive through the prefetch
    iterator (native C++ thread pool when available) and point clouds
    leave through a background writer thread, so per-frame wall time is
    the tracking step alone — read and write legs are hidden (the
    reference's loop blocks on both, CCalculation.cpp:221-316; so did
    this runner before round 4). ``stream=False`` keeps the strict
    read->step->write loop. Fault records, re-anchoring, and
    checkpoint/resume behave identically in both paths (regression-
    tested). ``out_format``: "xyz" reference-format ASCII or "npz"
    float32 maps. ``chunk`` > 1 (stream
    mode) scans K consecutive frames per device dispatch
    (streaming.chunk_step_xyz) — for dispatch-bound hosts; fault
    records, anchors, and checkpoint/resume semantics are preserved
    (checkpoints land on chunk boundaries).

    If the dataset contains anchor groups (``aFrame{f}/``, written by
    ``write_anchor_group``) and ``use_anchors`` is set, the tracker is
    re-anchored at those frames: the frame's output comes from a fresh
    absolute decode and the integrated P is reset, bounding the drift
    of P[f] = P[f-1] + deltaP (which the reference never corrects,
    CCalculation.cpp:656-660).

    Outputs (mirroring CCalculation::Result's file-per-frame layout,
    CCalculation.cpp:89-93, :193-197, :310-315):
      <out_dir>/iFrame.txt, <out_dir>/cFrame{N}.txt, <out_dir>/metrics.jsonl
    """
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(calib, str):
        calib = load_calibration(calib)
    ds = ReplayDataset(dataset_root, gray_count=2 * cfg.gray_bits,
                       phase_count=cfg.phase_steps)
    if fault_drop_prob or fault_corrupt_prob:
        from slc_tpu.io.dataset import FaultInjector
        ds = FaultInjector(ds, fault_drop_prob, fault_corrupt_prob,
                           fault_seed)
    tables = build_tables(calib, cfg.cam_h, cfg.cam_w)
    log = MetricsLog()

    # Logical per-stage bytes (bytes/pixel: what a stage must read and
    # write at least) so metrics.jsonl reports achieved GB/s per stage
    # (SURVEY §5): decode reads N u8 images and writes 4 f32 maps; the
    # dynamic step, open-loop or phase-locked, reads 1 u8 + 3 f32 and
    # writes 6 f32 = 37 B/px. The rate is taken on the host clock
    # around a blocking call, so it includes dispatch.
    px = cfg.cam_h * cfg.cam_w
    if mode == "heterodyne":
        from slc_tpu.config import HeterodyneConfig as _Het
        n_in = _Het(phase_steps=cfg.phase_steps).num_images
        first_bytes = px * (n_in + 16)
    elif mode == "gray":
        first_bytes = px * (2 * cfg.gray_bits + cfg.phase_steps + 16)
    else:
        first_bytes = None     # spatial: CG iteration count is dynamic
    step_bytes = 37 * px

    # --- frame 0: absolute decode (CalculateFirst) -------------------
    if mode == "gray":
        g0 = jnp.asarray(ds.gray_images())
        p0 = jnp.asarray(ds.phase_images())
        do_decode = lambda: decode_first_frame(g0, p0, tables, cfg)
    elif mode == "heterodyne":
        from slc_tpu.config import HeterodyneConfig
        het = HeterodyneConfig(phase_steps=cfg.phase_steps)
        f0 = jnp.asarray(ds.fringe_images(het.num_images))
        do_decode = lambda: decode_heterodyne_frame(f0, tables, cfg, het)
    elif mode == "spatial":
        p0 = jnp.asarray(ds.phase_images())
        do_decode = lambda: decode_spatial_frame(
            p0, tables, cfg, float(cfg.phase_period))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    # Warm the jit compile OUT of the timed stage — the first call's
    # trace+compile (seconds) would otherwise make the stage's
    # achieved-GB/s metric meaningless.
    jax.block_until_ready(do_decode().z)
    with stage("slc/first_frame", log, bytes_moved=first_bytes):
        first = do_decode()
        jax.block_until_ready(first.z)
    ext = "npz" if out_format == "npz" else "txt"
    _write_frame = (cloud.write_cloud_npz if out_format == "npz"
                    else cloud.write_xyz)
    n_pts = 0
    if write_clouds:
        with stage("slc/write", log):
            n_pts = _write_frame(os.path.join(out_dir, f"iFrame.{ext}"),
                                 np.asarray(first.x), np.asarray(first.y),
                                 np.asarray(first.z))
    if save_depth:
        # Machine-readable depth for downstream multi-scan fusion
        # (``python -m slc_tpu fuse``): the ASCII clouds drop pixel
        # indexing, which projective association needs.
        np.savez(os.path.join(out_dir, "depth_iFrame.npz"),
                 z=np.asarray(first.z, np.float32),
                 cam_k=np.asarray(calib.cam_k, np.float32))
    if preview:
        _write_preview(out_dir, "preview_iFrame", first.z, calib)
    log.log_frame(0, frame_stats(first.z))

    # Phase-locked tracking (VERDICT r3 item 1): resolve the stripe
    # period from the manifest and the demod window from the frame-0
    # absolute map.
    lock_period = None
    if phase_lock == "auto":
        sp = (ds.manifest or {}).get("stripe_period")
        lock_period = float(sp) if sp else None
    elif phase_lock is not None:
        lock_period = float(phase_lock)
    lock_win = 9
    if lock_period is not None and lock_window is None:
        from slc_tpu.ops.demod import suggest_lock_window
        lock_win = suggest_lock_window(np.asarray(first.proj_u),
                                       lock_period)
    elif lock_window is not None:
        lock_win = int(lock_window)

    if lock_period is not None and ds.frame_count:
        # Period diagnostic (+ opt-in refinement) from the first
        # dynamic frame vs the frame-0 absolute map. Read through the
        # BASE dataset (same invariant as the warm-up below): a
        # FaultInjector draws its RNG per frame() call, so going
        # through the wrapper would both shift the whole run's
        # injected-fault sequence and let the diagnostic demodulate an
        # injected-noise frame — with refine_period that would adopt a
        # garbage period, the exact failure this diagnostic prevents.
        from slc_tpu.ops.demod import estimate_period
        try:
            base_ds = getattr(ds, "ds", ds)
            t_est = float(estimate_period(
                jnp.asarray(base_ds.frame(0)), first.proj_u,
                float(lock_period), win_u=int(lock_win)))
        except (IOError, OSError, ValueError):
            t_est = None
        if t_est is not None:
            dev = abs(t_est / lock_period - 1.0)
            log.summaries.append(
                {"period_diag": True,
                 "period_nominal": float(lock_period),
                 "period_estimated": round(t_est, 5),
                 "period_deviation_pct": round(dev * 100, 3),
                 "period_adopted": bool(refine_period)})
            if dev > 0.01:
                import warnings
                warnings.warn(
                    f"configured stripe period {lock_period} deviates "
                    f"{dev * 100:.1f}% from the measured carrier "
                    f"({t_est:.4f}); the carrier-consistency gate "
                    f"will disable the lock at >= ~2% — pass "
                    f"refine_period=True (CLI --refine-period) to "
                    f"adopt the measured value", stacklevel=2)
            if refine_period:
                # Adopt only inside the estimator's documented
                # validity envelope (~+-10% from nominal; beyond that
                # the demodulated amplitude collapses and the slope
                # regression returns garbage — possibly negative or
                # non-finite).
                import math as _math
                if _math.isfinite(t_est) and dev < 0.1:
                    lock_period = t_est
                else:
                    import warnings
                    warnings.warn(
                        f"refine_period: measured period {t_est!r} is "
                        f"outside the estimator's validity envelope "
                        f"(>10% from the configured {lock_period}); "
                        f"keeping the configured value", stacklevel=2)

    def step(st, frame_dev):
        return dynamic_step(st, frame_dev, tables, cfg, scale_gradient,
                            subpixel, robust, phase_lock=lock_period,
                            lock_win_u=lock_win)

    # --- dynamic loop (CalculateOther) -------------------------------
    ckpt_dir = os.path.join(out_dir, "ckpt")
    start_frame = 1
    state = None
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            state = load_state(latest)
            start_frame = int(np.asarray(state.frame_idx)) + 1
    if state is None:
        if not ds.frame_count:
            return RunReport(0, n_pts, log)
        # Bounded retry for the tracking anchor frame — the analog of
        # the reference camera's 30-attempt snapshot loop
        # (CCamera.cpp:97-107).
        frame0 = None
        for _ in range(30):
            try:
                frame0 = ds.frame(0)
                break
            except (IOError, OSError):
                continue
        if frame0 is None:
            raise IOError("frame 0 unreadable after 30 attempts")
        state = init_tracker(jnp.asarray(frame0), first.proj_u, first.z,
                             cfg, subpixel)

    total = ds.frame_count if max_frames is None \
        else min(ds.frame_count, max_frames)
    anchor_set = set(ds.anchor_frames()) if use_anchors else set()
    if start_frame < total:
        # Warm the dynamic-step compile on a donation-safe state copy
        # so the first frame's stage metric times execution, not
        # trace+compile (best-effort — a read failure here is handled
        # by the loop's own fault path).
        try:
            # Read through the BASE dataset: a FaultInjector draws from
            # its RNG per frame() call, and the warm-up must not shift
            # the injected-fault sequence the run will see.
            base_ds = getattr(ds, "ds", ds)
            warm_frame = jnp.asarray(base_ds.frame(start_frame))
            warm_state = jax.tree.map(
                lambda a: a + 0 if hasattr(a, "dtype") else a, state)
            ws, _ = step(warm_state, warm_frame)
            jax.block_until_ready(ws.z)
        except (IOError, OSError, ValueError):
            pass

    # Frame source: prefetched indexed iteration (native C++ thread
    # pool when available) in stream mode, strict synchronous reads
    # otherwise. Both yield (index, frame-or-None, error-or-None) with
    # identical per-index fault semantics.
    if stream:
        frame_source = ds.indexed_frames(start=start_frame, stop=total,
                                         prefetch=8)
    else:
        def _strict_source():
            for i in range(start_frame, total):
                try:
                    yield i, ds.frame(i), None
                except (IOError, OSError, ValueError) as e:
                    yield i, None, str(e)
        frame_source = _strict_source()

    writer = None
    if write_clouds and stream:
        writer = cloud.AsyncCloudWriter(fmt=out_format)

    def emit(f, res):
        path = os.path.join(out_dir, f"cFrame{f}.{ext}")
        if writer is not None:
            writer.submit(path, res.x, res.y, res.z)
        elif write_clouds:
            with stage("slc/write", log):
                _write_frame(path, np.asarray(res.x), np.asarray(res.y),
                             np.asarray(res.z))

    # Chunked megastep (``chunk`` > 1, stream mode): consecutive
    # non-anchor frames are scanned in ONE device dispatch
    # (streaming.chunk_step_xyz), amortizing the per-frame dispatch
    # cost that bounds per-frame wall on dispatch-bound hosts. Faults,
    # anchors and the sequence end flush the pending buffer first, so
    # per-frame fault records and anchor semantics are unchanged;
    # checkpoints land on chunk boundaries (frame_idx = last processed
    # frame — resume semantics identical).
    chunked = stream and chunk > 1
    if chunked:
        from slc_tpu.streaming import chunk_step_xyz
    chunk_buf: list = []

    def flush():
        nonlocal state, done
        if not chunk_buf:
            return
        idxs = [cf for cf, _ in chunk_buf]
        if len(idxs) == chunk:
            stack = jnp.asarray(np.stack([fr for _, fr in chunk_buf]))
            with stage("slc/dynamic_chunk", log,
                       bytes_moved=step_bytes * len(idxs)):
                state, (zs, xs, ys) = chunk_step_xyz(
                    state, stack, tables, cfg, scale_gradient,
                    subpixel, robust, phase_lock=lock_period,
                    lock_win_u=lock_win)
                jax.block_until_ready(zs)
            for j, cf in enumerate(idxs):
                emit(cf, FrameResult(x=xs[j], y=ys[j], z=zs[j],
                                     proj_u=None))
                log.log_frame(cf, frame_stats(zs[j]))
        else:
            # Ragged tail / anchor-split partial: single-step path
            # (no extra chunk-shape compile).
            for cf, fr in chunk_buf:
                state, res = step(state, jnp.asarray(fr))
                jax.block_until_ready(res.z)
                emit(cf, res)
                log.log_frame(cf, frame_stats(res.z))
        if checkpoint_every and any(
                cf % checkpoint_every == 0 for cf in idxs):
            os.makedirs(ckpt_dir, exist_ok=True)
            save_state(os.path.join(ckpt_dir, f"frame_{idxs[-1]}"),
                       state)
        done = idxs[-1]
        chunk_buf.clear()

    done = start_frame - 1
    loop_exc = None
    try:
        for f, frame, err in frame_source:
            if frame is None:
                # ValueError = read_bmp decode failure on a corrupt
                # on-disk frame — same fault class as an unreadable
                # file. Failure recovery (absent in the reference,
                # which proceeds with empty images — CSensorV.cpp:
                # 122-129): skip the frame, carry the tracker state,
                # record the fault (buffered frames first, so the
                # logged state is current).
                flush()
                log.log_frame(f, frame_stats(state.z), fault=err)
                continue
            if chunked and f not in anchor_set:
                chunk_buf.append((f, frame))
                if len(chunk_buf) == chunk:
                    flush()
                continue
            if f in anchor_set:
                flush()
                # Periodic absolute re-anchoring (SURVEY.md §5): this
                # frame's output is a fresh absolute decode; the
                # tracker state is rebuilt from it and the current
                # fringe frame.
                with stage("slc/reanchor", log):
                    res = _decode_anchor(ds, f, tables, cfg, mode,
                                         prev_proj_u=state.proj_u)
                    state = reanchor(state, jnp.asarray(frame),
                                     res.proj_u, res.z, cfg, subpixel)
                    state = dataclasses.replace(state,
                                                frame_idx=jnp.int32(f))
                emit(f, res)
                log.log_frame(f, frame_stats(res.z), reanchor=True)
            else:
                with stage("slc/dynamic_step", log,
                           bytes_moved=step_bytes):
                    state, res = step(state, jnp.asarray(frame))
                    jax.block_until_ready(res.z)
                emit(f, res)
                log.log_frame(f, frame_stats(res.z))
            if checkpoint_every and f % checkpoint_every == 0:
                os.makedirs(ckpt_dir, exist_ok=True)
                save_state(os.path.join(ckpt_dir, f"frame_{f}"), state)
            done = f
        flush()
    except BaseException as e:
        loop_exc = e
        raise
    finally:
        if writer is not None:
            try:
                summary = writer.close()
                log.summaries.append({"writer": True, **summary})
            except IOError:
                # Don't mask an in-flight loop exception with the
                # writer's failure report. (sys.exc_info() inside this
                # except block would see the IOError itself, so the
                # loop outcome is tracked explicitly.)
                if loop_exc is None:
                    raise

    if preview and done >= start_frame:
        _write_preview(out_dir, f"preview_cFrame{done}", state.z, calib)
    log.save(os.path.join(out_dir, "metrics.jsonl"))
    return RunReport(done, n_pts, log)


def _write_preview(out_dir: str, name: str, z, calib) -> str:
    """Shaded depth preview BMP (the depthMapUtils.cpp:167-187 render
    chain: bilateral -> normals -> Phong-style luminance), the visual
    artifact the reference only produces through its never-called
    renderDepthMap."""
    from slc_tpu import visualization
    k = np.asarray(calib.cam_k)
    lum = cloud.render_depth_map(z, float(k[0, 0]), float(k[1, 1]),
                                 float(k[0, 2]), float(k[1, 2]))
    return visualization.show(name, np.asarray(lum), out_dir=out_dir,
                              force=True)


def _decode_anchor(ds, f: int, tables, cfg: SystemConfig, mode: str,
                   prev_proj_u=None):
    """Absolute decode of the aFrame{f} pattern group, per mode.

    ``prev_proj_u`` (the tracker's current absolute map) anchors the
    spatial mode's unwrap: a spatial decode is absolute only up to one
    global period offset, so an unanchored re-anchor could snap the
    sequence onto a different fringe order and inject a period-sized
    depth jump mid-sequence. Gray and heterodyne decodes are absolute
    on their own and ignore it."""
    if mode == "gray":
        return decode_first_frame(jnp.asarray(ds.anchor_gray_images(f)),
                                  jnp.asarray(ds.anchor_phase_images(f)),
                                  tables, cfg)
    if mode == "heterodyne":
        from slc_tpu.config import HeterodyneConfig
        het = HeterodyneConfig(phase_steps=cfg.phase_steps)
        return decode_heterodyne_frame(
            jnp.asarray(ds.anchor_fringe_images(f, het.num_images)),
            tables, cfg, het)
    return decode_spatial_frame(jnp.asarray(ds.anchor_phase_images(f)),
                                tables, cfg, float(cfg.phase_period),
                                anchor=prev_proj_u)
