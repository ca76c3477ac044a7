"""On-card streaming pipeline: the pipelined loop (H2D of frame f+1
issued while frame f computes, no per-frame sync) must beat the strict
sequential loop on the GPU. Card-only (``gpu`` marker);
``python chip_smoke.py`` runs it."""

import jax.numpy as jnp
import pytest


@pytest.mark.gpu
def test_streaming_pipeline_beats_sequential_on_gpu(gpu):
    from slc_tpu import synth
    from slc_tpu.calib import synthetic_calibration, build_tables
    from slc_tpu.config import SystemConfig
    from slc_tpu.dynamic import init_tracker
    from slc_tpu.streaming import measure_overlap

    # 2 MP: the uint8 frame (2 MB) and the tracking step are both well
    # above timer noise.
    h, w = 1216, 1632
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    tables = build_tables(calib, h, w)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, 9, z0=50.0, dz_per_frame=0.05, stripe_period=12,
        noise_sigma=1.0)
    state = init_tracker(jnp.asarray(frames[0]),
                         jnp.asarray(pus[0], jnp.float32),
                         jnp.asarray(zs[0], jnp.float32), cfg)

    runs = [measure_overlap(state, frames[1:], tables, cfg)
            for _ in range(3)]
    print("overlap:", runs)
    # Measured in ten runs on H100s at 400 W and 700 W: the pipelined
    # loop ran 1.97-5.95x faster than the sequential one in every run,
    # but the share of the transfer hidden under compute
    # (overlap_efficiency) ranged 0.0-0.69 from run to run: the numpy ->
    # device copy is mostly host-side work. So the speedup is asserted,
    # the overlap only recorded.
    speedup = sorted(r["speedup_vs_sequential"] for r in runs)[1]
    assert speedup > 1.5, runs
