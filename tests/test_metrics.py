"""Metrics: stage wall-clock capture into MetricsLog records.

The reference's observability is printf banners (CCalculation.cpp:183,
:228-243); here per-stage timings must land in the structured per-frame
records (SURVEY.md §5).
"""

import json
import time

import jax.numpy as jnp

from slc_tpu.metrics import MetricsLog, frame_stats, stage


def test_stage_records_wall_clock(tmp_path):
    log = MetricsLog()
    with stage("slc/dynamic_step", log):
        time.sleep(0.01)
    with stage("slc/write", log, bytes_moved=100_000_000):
        time.sleep(0.01)
    rec = log.log_frame(3, frame_stats(jnp.ones((4, 4))))
    assert rec["t_dynamic_step_ms"] >= 10.0
    assert rec["t_write_ms"] >= 10.0
    assert rec["gbps_write"] > 0
    # Timings attach to exactly one frame.
    rec2 = log.log_frame(4, frame_stats(jnp.ones((4, 4))))
    assert "t_dynamic_step_ms" not in rec2

    p = tmp_path / "metrics.jsonl"
    log.save(str(p))
    lines = [json.loads(l) for l in p.read_text().splitlines()]
    assert lines[0]["t_dynamic_step_ms"] >= 10.0


def test_stage_without_log_is_fine():
    with stage("slc/anonymous"):
        pass
