"""Device time from profiler traces (slc_tpu.devtime): the union of GPU
stream intervals per call, and no host-clock fallback."""

import json
import os

import jax
import jax.numpy as jnp
import pytest

from slc_tpu import devtime

DATA = os.path.join(os.path.dirname(__file__), "data")


def _trace(events):
    """Chrome-format trace with one GPU (two streams) and one host
    thread; ``events`` are (tid, ts_us, dur_us), tid 1 on the host."""
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 13, "name": "thread_name",
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "pid": 1, "tid": 14, "name": "thread_name",
         "args": {"name": "Stream #14(MemcpyH2D)"}},
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 7, "tid": 1, "name": "thread_name",
         "args": {"name": "python"}},
    ]
    xs = [{"ph": "X", "pid": 7 if tid == 1 else 1, "tid": tid, "ts": ts,
           "dur": dur, "name": "k"} for tid, ts, dur in events]
    return {"traceEvents": meta + xs}


@pytest.mark.parametrize("events,busy", [
    ([(13, 0.0, 10.0)], 10.0),                          # one kernel
    ([(13, 0.0, 10.0), (13, 5.0, 10.0)], 15.0),         # overlap once
    ([(13, 0.0, 10.0), (14, 2.0, 4.0)], 10.0),          # nested copy
    ([(13, 0.0, 10.0), (13, 20.0, 5.0)], 15.0),         # idle gap out
    ([(13, 0.0, 10.0), (1, 0.0, 100.0)], 10.0),         # host ignored
])
def test_busy_union(events, busy):
    t = _trace(events)
    assert devtime.busy_us(devtime.device_intervals(t)) == pytest.approx(
        busy)
    assert devtime.trace_device_time_s(t, 2) == pytest.approx(
        busy / 2 / 1e6)


def test_recorded_h100_trace():
    """Three calls of a two-kernel jit, recorded on an NVIDIA H100 80GB
    HBM3 (700 W): six kernels on one compute stream, never overlapping,
    so the device time per call is a third of their summed durations;
    the host thread's spans (which cover the kernels) do not count."""
    with open(os.path.join(DATA, "h100_trace_3calls.json")) as f:
        t = json.load(f)
    iv = devtime.device_intervals(t)
    assert len(iv) == 6
    total = sum(e["dur"] for e in t["traceEvents"]
                if e.get("ph") == "X" and e["pid"] == 1)
    assert devtime.trace_device_time_s(t, 3) == pytest.approx(
        total / 3 / 1e6)


def test_trace_without_device_events_is_refused():
    with pytest.raises(ValueError, match="no GPU device events"):
        devtime.trace_device_time_s(_trace([(1, 0.0, 50.0)]), 1)


def test_device_time_refuses_a_backend_without_device_events():
    """On the CPU backend the trace holds host threads only: the
    measurement fails instead of returning host wall time."""
    if jax.default_backend() == "gpu":
        pytest.skip("checks the refusal on a backend without a GPU")
    f = jax.jit(lambda x: jnp.sin(x) * 2.0)
    x = jnp.ones((64, 64), jnp.float32)
    with pytest.raises(ValueError, match="no GPU device events"):
        devtime.device_time_s(lambda: f(x), n=2)


@pytest.mark.gpu
def test_device_time_on_gpu(gpu):
    """On the card: positive, and no more than the host wall time of
    the same calls (the device cannot be busy longer than the host
    waited for it)."""
    import time
    f = jax.jit(lambda x: jnp.cumsum(jnp.sin(x), axis=0) * 2.0)
    x = jnp.ones((2048, 2048), jnp.float32)
    dt = devtime.device_time_s(lambda: f(x), n=10)
    t0 = time.perf_counter()
    for _ in range(10):
        out = f(x)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / 10
    assert 0.0 < dt <= wall * 1.05, (dt, wall)
