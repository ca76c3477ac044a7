"""Device time from the JAX profiler's trace.

Host wall clock around ``block_until_ready`` counts dispatch and
synchronisation as well as the work; a roofline comparison needs the
time the device itself was busy. On XLA:GPU one jitted call is many
kernels, so the device time of a call is the union of the intervals in
which any kernel or copy ran on a GPU stream, not the duration of one
event. The reduction is kept here as code and checked against a small
recorded H100 trace (tests/test_devtime.py).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import tempfile
from typing import Callable, Iterable, List, Tuple

import jax


def device_intervals(trace: dict) -> List[Tuple[float, float]]:
    """(start_us, end_us) of every event on a GPU stream of a Chrome-
    format profiler trace (``traceEvents``): events of the processes
    named ``/device:GPU:<n>``, on their ``Stream #...`` threads."""
    ev = trace.get("traceEvents", [])
    gpu_pids = {e["pid"] for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and e["args"].get("name", "").startswith("/device:GPU")}
    streams = {(e["pid"], e["tid"]) for e in ev
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e["pid"] in gpu_pids
               and e["args"].get("name", "").startswith("Stream")}
    return [(e["ts"], e["ts"] + e["dur"]) for e in ev
            if e.get("ph") == "X" and "dur" in e
            and (e.get("pid"), e.get("tid")) in streams]


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals`` (overlaps counted once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_device_time_s(trace: dict, n: int) -> float:
    """Device-busy seconds per call of a trace that holds ``n`` calls.
    Raises ValueError when the trace has no GPU device events: a host
    clock is never substituted for the device's."""
    iv = device_intervals(trace)
    if not iv:
        raise ValueError("the trace holds no GPU device events")
    return busy_us(iv) / n / 1e6


def device_time_s(fn: Callable[[], object], n: int = 20) -> float:
    """Device-busy seconds per call of ``fn`` (which runs the jitted
    work and returns its output), from a profiler trace of ``n`` calls
    after one warm-up call. Raises ValueError on a backend that records
    no GPU device events."""
    jax.block_until_ready(fn())            # warm-up / compile
    tmp = tempfile.mkdtemp(prefix="slc_devtime_")
    try:
        with jax.profiler.trace(tmp):
            out = None
            for _ in range(n):
                out = fn()
            jax.block_until_ready(out)
        traces = glob.glob(
            os.path.join(tmp, "**", "*.trace.json.gz"), recursive=True)
        if not traces:
            raise ValueError("the profiler wrote no trace")
        with gzip.open(traces[-1]) as f:
            trace = json.load(f)
        return trace_device_time_s(trace, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_HLO_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
              "s16": 2, "u16": 2, "u8": 1, "s8": 1, "pred": 1,
              "f64": 8, "s64": 8, "u64": 8}


def hlo_collective_bytes(compiled_text: str) -> dict:
    """Per-device collective-communication bytes of a compiled (SPMD)
    program, counted from its optimized HLO: every `collective-permute`
    (halo exchange / ppermute), `all-reduce` (psum), `all-gather`, and
    `reduce-scatter` instruction's RESULT shape, summed per category.

    This is the exact per-execution transfer volume of the compiled
    artifact — the measured backing for comms accounting that analytic
    footprints only estimate. `collective-permute`
    result bytes equal the bytes each device receives (= sends) per
    execution; `all-reduce` counts the reduced tensor once per device.

    Use: ``hlo_collective_bytes(jax.jit(f).lower(*args).compile()
    .as_text())``.
    """
    import re
    totals = {"collective-permute": 0, "all-reduce": 0,
              "all-gather": 0, "reduce-scatter": 0, "ops": 0}
    # e.g.:  %collective-permute.3 = f32[620,408]{1,0} collective-permute(
    pat = re.compile(
        r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
        r"(collective-permute|all-reduce|all-gather|reduce-scatter)"
        r"(?:-start)?\(")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\]")

    def shape_bytes(dtype, dims):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        return n * _HLO_BYTES.get(dtype, 4)

    for m in pat.finditer(compiled_text):
        tuple_body, dtype, dims, kind = m.groups()
        if tuple_body is not None:
            b = sum(shape_bytes(dt, dm)
                    for dt, dm in shape_pat.findall(tuple_body))
            # -start ops carry (operand, result[, ...]) tuples; count
            # the result once (half the unique operand/result pair).
            b //= 2
        else:
            b = shape_bytes(dtype, dims)
        totals[kind] += b
        totals["ops"] += 1
    totals["total"] = (totals["collective-permute"]
                       + totals["all-reduce"] + totals["all-gather"]
                       + totals["reduce-scatter"])
    return totals
