"""Streaming loop: pipelined results must equal the synchronous loop."""

import numpy as np
import pytest
import jax.numpy as jnp

from slc_tpu import synth
from slc_tpu.calib import synthetic_calibration, build_tables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import init_tracker, dynamic_step
from slc_tpu.streaming import run_streaming, stream_frames

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)


def test_streaming_matches_synchronous():
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 5, z0=50.0, dz_per_frame=0.4, stripe_period=12)

    def mk_state():
        return init_tracker(jnp.asarray(frames[0]),
                            jnp.asarray(pus[0], jnp.float32),
                            jnp.asarray(zs[0], jnp.float32), CFG)

    # Synchronous reference.
    state = mk_state()
    ref_z = []
    for f in range(1, 5):
        state, res = dynamic_step(state, jnp.asarray(frames[f]),
                                  tables, CFG)
        ref_z.append(np.asarray(res.z))

    # Pipelined.
    got_z = [np.asarray(r.z) for _, r in
             stream_frames(mk_state(), frames[1:], tables, CFG)]
    assert len(got_z) == 4
    for a, b in zip(got_z, ref_z):
        np.testing.assert_array_equal(a, b)


def test_chunked_stream_matches_per_frame():
    """stream_chunks (K frames per lax.scan dispatch) must reproduce
    the per-frame loop bit-exactly, including a ragged tail chunk and
    device-array inputs."""
    from slc_tpu.streaming import stream_chunks

    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 9, z0=50.0, dz_per_frame=0.4, stripe_period=12)

    def mk_state():
        return init_tracker(jnp.asarray(frames[0]),
                            jnp.asarray(pus[0], jnp.float32),
                            jnp.asarray(zs[0], jnp.float32), CFG)

    state = mk_state()
    ref_z = []
    for f in range(1, 9):
        state, res = dynamic_step(state, jnp.asarray(frames[f]),
                                  tables, CFG)
        ref_z.append(np.asarray(res.z))
    ref_pu = np.asarray(state.proj_u)

    # 8 frames in chunks of 3 -> 3 + 3 + ragged tail of 2.
    got_z = []
    for st, z_stack in stream_chunks(mk_state(), list(frames[1:]),
                                     tables, CFG, chunk=3):
        got_z.extend(np.asarray(z_stack))
    assert len(got_z) == 8
    for a, b in zip(got_z, ref_z):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(st.proj_u), ref_pu)

    # Device-array feed stacks on device; same results.
    dev = [jnp.asarray(f) for f in frames[1:]]
    got2 = []
    for st2, z_stack in stream_chunks(mk_state(), dev, tables, CFG,
                                      chunk=4):
        got2.extend(np.asarray(z_stack))
    for a, b in zip(got2, ref_z):
        np.testing.assert_array_equal(a, b)


def test_run_streaming_chunked_stats():
    from slc_tpu.streaming import run_streaming

    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 7, z0=50.0, dz_per_frame=0.4, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    fetched = []
    _, stats = run_streaming(state, frames[1:], tables, CFG, chunk=3,
                             fetch_z=lambda z: fetched.append(z.shape))
    s = stats.summary()
    assert s["frames"] == 6 and s["fps"] > 0
    assert fetched == [(3, CFG.cam_h, CFG.cam_w),
                       (3, CFG.cam_h, CFG.cam_w)]


def test_run_streaming_stats():
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 4, z0=50.0, dz_per_frame=0.4, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    _, stats = run_streaming(state, frames[1:], tables, CFG)
    s = stats.summary()
    assert s["frames"] == 3 and s["fps"] > 0


def test_measure_overlap_reports_consistent_timings():
    """measure_overlap's four legs must be self-consistent on any
    backend: pipelined <= sequential * 1.5 (timer noise allowance) and
    all keys present. The real overlap assertion runs on the GPU only
    (test_streaming_gpu.py) — CPU device_put is a synchronous copy."""
    from slc_tpu.streaming import measure_overlap
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 5, z0=50.0, dz_per_frame=0.1, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    ov = measure_overlap(state, frames[1:], tables, CFG)
    for k in ("compute_ms", "transfer_ms", "pipelined_ms",
              "sequential_ms", "overlap_efficiency",
              "speedup_vs_sequential"):
        assert k in ov, k
    assert ov["frames"] == 4
    assert 0.0 <= ov["overlap_efficiency"] <= 1.0
    assert ov["pipelined_ms"] > 0 and ov["sequential_ms"] > 0


def test_streaming_robust_flag_passthrough():
    """robust=False must reach dynamic_step through both streaming
    paths (code-review r3: it was silently pinned to True)."""
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 5, z0=50.0, dz_per_frame=0.4, stripe_period=12)

    def mk_state(subpixel=True):
        return init_tracker(jnp.asarray(frames[0]),
                            jnp.asarray(pus[0], jnp.float32),
                            jnp.asarray(zs[0], jnp.float32), CFG,
                            subpixel=subpixel)

    def ref(robust):
        st = mk_state()
        out = []
        for f in range(1, 5):
            st, res = dynamic_step(st, jnp.asarray(frames[f]), tables,
                                   CFG, robust=robust)
            out.append(np.asarray(res.z))
        return out

    ref_t, ref_f = ref(True), ref(False)
    assert any(not np.array_equal(a, b) for a, b in zip(ref_t, ref_f)), \
        "robust flag must change results on this scene"

    got = [np.asarray(r.z) for _, r in
           stream_frames(mk_state(), frames[1:], tables, CFG,
                         robust=False)]
    for a, b in zip(got, ref_f):
        np.testing.assert_array_equal(a, b)

    from slc_tpu.streaming import stream_chunks
    got2 = []
    for _, z_stack in stream_chunks(mk_state(), list(frames[1:]),
                                    tables, CFG, chunk=2, robust=False):
        got2.extend(np.asarray(z_stack))
    for a, b in zip(got2, ref_f):
        np.testing.assert_array_equal(a, b)


def test_run_streaming_chunk_rejects_per_frame_args():
    """chunk > 1 must reject per-frame `fetch`/`sync_every` instead of
    silently dropping them (ADVICE r3)."""
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 4, z0=50.0, dz_per_frame=0.4, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    with pytest.raises(ValueError, match="chunk"):
        run_streaming(state, frames[1:], tables, CFG, chunk=2,
                      fetch=lambda r: r)


def test_run_streaming_ragged_chunk_latencies():
    """Per-chunk latencies are recorded directly; a ragged final chunk
    (7 frames, chunk=3 -> sizes 3, 3, 1) must be represented exactly
    (ADVICE r3: the [::K] stride reconstruction mis-binned it)."""
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 8, z0=50.0, dz_per_frame=0.4, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    _, stats = run_streaming(state, frames[1:], tables, CFG, chunk=3)
    assert stats.chunk_sizes == [3, 3, 1]
    assert len(stats.chunk_latencies_s) == 3
    assert len(stats.latencies_s) == 7
    for dt, k in zip(stats.chunk_latencies_s, stats.chunk_sizes):
        assert dt > 0 and k >= 1


def test_measure_overlap_compute_repeats():
    """compute_repeats scales the compute leg (one dispatch per frame)
    and records the measurement regime."""
    from slc_tpu.streaming import measure_overlap
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, CFG, 5, z0=50.0, dz_per_frame=0.4, stripe_period=12)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), CFG)
    ov = measure_overlap(state, frames[1:], tables, CFG,
                         compute_repeats=3)
    assert ov["compute_repeats"] == 3
    assert ov["regime"] in ("balanced", "transfer_bound",
                            "compute_bound")
    assert 0.0 < ov["leg_ratio"] <= 1.0
    ov_auto = measure_overlap(state, frames[1:], tables, CFG,
                              compute_repeats="auto")
    assert ov_auto["compute_repeats"] >= 1
