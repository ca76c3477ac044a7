"""Streaming dynamic reconstruction with transfer/compute overlap
(BASELINE config 4).

The reference's dynamic loop is strictly synchronous: imread -> track ->
write, one frame at a time (CCalculation.cpp:221-316). Here the loop is
pipelined using JAX's asynchronous dispatch:

  * frame f+1's uint8 host->device transfer is issued while frame f's
    step is still executing on device (double buffering — the transfer
    rides the DMA engines, the step the compute units),
  * the depth result of frame f-1 is copied device->host concurrently
    (``copy_to_host_async``),

so steady-state wall time per frame is max(compute, transfer), not their
sum. The tracker state itself never leaves the device and is donated
buffer-to-buffer (slc_tpu.dynamic.dynamic_step).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from slc_tpu.calib import TriangulationTables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import TrackerState, dynamic_step
from slc_tpu.pipeline import FrameResult


@dataclasses.dataclass
class StreamStats:
    """Per-frame latency / throughput of a streaming run.

    In chunked mode, ``chunk_latencies_s``/``chunk_sizes`` record the
    per-chunk sync-to-sync wall times directly (a ragged final chunk
    makes them unrecoverable from the flattened per-frame list)."""
    latencies_s: List[float]
    chunk_latencies_s: Optional[List[float]] = None
    chunk_sizes: Optional[List[int]] = None

    @property
    def fps(self) -> float:
        return len(self.latencies_s) / max(sum(self.latencies_s), 1e-12)

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.latencies_s), q) * 1e3)

    def summary(self) -> dict:
        return {"frames": len(self.latencies_s),
                "fps": round(self.fps, 2),
                "p50_ms": round(self.percentile_ms(50), 3),
                "p95_ms": round(self.percentile_ms(95), 3)}


def stream_frames(state: TrackerState, frames: Iterable[np.ndarray],
                  tables: TriangulationTables, cfg: SystemConfig,
                  fetch: Optional[Callable[[FrameResult], object]] = None,
                  scale_gradient: bool = True, subpixel: bool = True,
                  robust: bool = True
                  ) -> Iterator[Tuple[TrackerState, object]]:
    """Pipelined streaming loop. Yields (state, fetched) per frame where
    ``fetched`` is ``fetch(result)`` (default: the result with its z
    transferred host-side asynchronously one frame behind).

    The yielded state of frame f is NOT synchronized; callers needing
    host values must block explicitly (the checkpoint path does). The
    carried state is DONATED into each step (dynamic_step semantics):
    consume a yielded state before advancing the iterator — the
    previous yield's buffers are reused by the next step.
    """
    if fetch is None:
        def fetch(res: FrameResult):
            res.z.copy_to_host_async()
            return res

    pending = None          # device frame awaiting compute
    for frame in frames:
        dev = jax.device_put(frame)         # async H2D for frame f+1
        if pending is not None:
            state, res = dynamic_step(state, pending, tables, cfg,
                                      scale_gradient, subpixel, robust)
            yield state, fetch(res)
        pending = dev
    if pending is not None:
        state, res = dynamic_step(state, pending, tables, cfg,
                                  scale_gradient, subpixel, robust)
        yield state, fetch(res)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "scale_gradient", "subpixel",
                                    "robust", "phase_lock",
                                    "lock_win_u", "lock_win_v"),
                   donate_argnames=("state",))
def _chunk_scan(state: TrackerState, frames: jax.Array,
                tables: TriangulationTables, cfg: SystemConfig,
                scale_gradient: bool, subpixel: bool, robust: bool,
                phase_lock=None, lock_win_u: int = 9,
                lock_win_v: int = 9
                ) -> Tuple[TrackerState, jax.Array]:
    """K dynamic steps in ONE dispatch: ``lax.scan`` over a (K, H, W)
    frame chunk, returning the K depth maps batched. The tracker state
    is donated, so the megastep is allocation-free across chunks."""
    def body(s, f):
        s, res = dynamic_step(s, f, tables, cfg, scale_gradient,
                              subpixel, robust, phase_lock=phase_lock,
                              lock_win_u=lock_win_u,
                              lock_win_v=lock_win_v)
        return s, res.z
    return jax.lax.scan(body, state, frames)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "scale_gradient", "subpixel",
                                    "robust", "phase_lock",
                                    "lock_win_u", "lock_win_v"),
                   donate_argnames=("state",))
def chunk_step_xyz(state: TrackerState, frames: jax.Array,
                   tables: TriangulationTables, cfg: SystemConfig,
                   scale_gradient: bool = True, subpixel: bool = True,
                   robust: bool = True, phase_lock=None,
                   lock_win_u: int = 9, lock_win_v: int = 9
                   ) -> Tuple[TrackerState, Tuple[jax.Array, ...]]:
    """K dynamic steps in one dispatch returning the full per-frame
    outputs (z, x, y) stacked (K, H, W) — the runner's chunked-CLI
    megastep (``run --chunk``), where every frame's point cloud is
    written. ``_chunk_scan`` (z only) remains the lighter bench/library
    variant. State is donated."""
    def body(s, f):
        s, res = dynamic_step(s, f, tables, cfg, scale_gradient,
                              subpixel, robust, phase_lock=phase_lock,
                              lock_win_u=lock_win_u,
                              lock_win_v=lock_win_v)
        return s, (res.z, res.x, res.y)
    return jax.lax.scan(body, state, frames)


def stream_chunks(state: TrackerState, frames: Iterable[np.ndarray],
                  tables: TriangulationTables, cfg: SystemConfig,
                  chunk: int,
                  scale_gradient: bool = True, subpixel: bool = True,
                  robust: bool = True, phase_lock=None,
                  lock_win_u: int = 9, lock_win_v: int = 9
                  ) -> Iterator[Tuple[TrackerState, jax.Array]]:
    """Chunked streaming megastep (VERDICT r2 item 1): amortize host
    dispatch over K frames per device program.

    The per-frame loop (``stream_frames``) pays one host dispatch per
    frame; where that dispatch costs more than the device step, it caps
    throughput below what the device sustains. This variant scans K
    frames per dispatch (``_chunk_scan``) with the NEXT chunk's H2D
    transfer issued before blocking on the current chunk's compute, so
    steady-state wall time per frame is

        max(device_step, H2D/frame) + dispatch / K.

    Latency/throughput trade: results arrive K frames at a time, so
    per-frame latency grows to ~K * device_step; pick K to clear the
    dispatch floor, not more.

    Yields (state, z_stack) per chunk, z_stack (k, H, W) float32 with
    k == ``chunk`` except for a possibly-smaller final chunk, which is
    run frame-at-a-time through the already-compiled single-step path
    to avoid a tail-shape recompile. Frames may be host numpy arrays
    (stacked then transferred once per chunk) or device arrays
    (stacked on device, no host round-trip).

    DONATION: like dynamic_step, the carried state is donated into
    each megastep — the initial ``state`` and every yielded state
    except the last are invalidated as the iteration advances. Snapshot
    (e.g. ``jax.tree.map(np.asarray, st)``) before advancing if you
    need to keep one.

    The frame-to-frame dependency P[f] = P[f-1] + deltaP
    (CCalculation.cpp:656-660) is preserved exactly: the scan is
    sequential on device; chunking changes dispatch granularity, not
    semantics (parity-tested in tests/test_streaming.py).
    """
    assert chunk >= 1

    def put(buf):
        if isinstance(buf[0], jax.Array):
            return jnp.stack(buf)          # device-side, no host trip
        return jax.device_put(np.stack(buf))

    pending = None
    buf: List[np.ndarray] = []
    for f in frames:
        buf.append(f)
        if len(buf) == chunk:
            dev = put(buf)                 # async H2D for chunk i+1
            buf = []
            if pending is not None:
                state, zs = _chunk_scan(state, pending, tables, cfg,
                                        scale_gradient, subpixel,
                                        robust, phase_lock, lock_win_u,
                                        lock_win_v)
                yield state, zs
            pending = dev
    if pending is not None:
        state, zs = _chunk_scan(state, pending, tables, cfg,
                                scale_gradient, subpixel, robust,
                                phase_lock, lock_win_u, lock_win_v)
        yield state, zs
    if buf:
        # Ragged tail: single-step path (no new chunk-shape compile).
        for f in buf:
            state, res = dynamic_step(state, jax.device_put(f), tables,
                                      cfg, scale_gradient, subpixel,
                                      robust, phase_lock=phase_lock,
                                      lock_win_u=lock_win_u,
                                      lock_win_v=lock_win_v)
            yield state, res.z[None]


def measure_overlap(state: TrackerState, frames: List[np.ndarray],
                    tables: TriangulationTables, cfg: SystemConfig,
                    scale_gradient: bool = True, subpixel: bool = True,
                    compute_repeats: "int | str" = 1) -> dict:
    """Quantify transfer/compute overlap in the streaming loop
    (VERDICT round 1, item 4: demonstrate it, don't just implement it).

    Measures three per-frame times over the same frame list:

      * ``compute_ms``  — frames pre-staged on device, steps back to
        back (pure compute).
      * ``transfer_ms`` — H2D ``device_put`` of every frame, no compute
        (pure transfer, DMAs pipelined).
      * ``pipelined_ms``— the real ``stream_frames`` loop: H2D of frame
        f+1 issued while frame f computes.
      * ``sequential_ms``— the reference-style strict loop: block the
        transfer, then block the step, per frame (no overlap possible).

    If the transfer truly rides under compute (or vice versa),
    ``pipelined ≈ max(compute, transfer)``; if not, ``≈ compute +
    transfer``. ``overlap_efficiency`` maps those to 1.0 / 0.0:

        (compute + transfer - pipelined) / min(compute, transfer)

    (clamped to [0, 1]; >0.5 means most of the cheaper leg is hidden).
    All timings exclude compilation (one warm-up pass runs first).

    ``compute_repeats``: the efficiency quotient is pure noise when one
    leg is a tiny fraction of the other (a slow host link makes the
    per-frame H2D many times the device step), so min(compute,
    transfer) sits in the measurement jitter. Setting
    R > 1 runs R tracking steps per frame (one dispatch, ``fori_loop``)
    so the compute leg scales into the transfer leg's range; "auto"
    calibrates R from quick single-leg probes to land the legs within
    ~20% of each other. The overlap *mechanism* measured (async H2D
    riding under device compute) is identical at any R. The result
    records the regime: ``compute_repeats``, ``leg_ratio`` =
    min/max of the two legs, and ``regime`` ("balanced" when
    leg_ratio >= 0.2, else which leg dominates — treat the efficiency
    as unmeasurable outside the balanced regime).
    """
    frames = list(frames)
    n = len(frames)
    assert n >= 2, "need >=2 frames to measure overlap"

    def single_step(st, dev):
        return dynamic_step(st, dev, tables, cfg, scale_gradient,
                            subpixel)

    @functools.partial(jax.jit, static_argnames=("reps",),
                       donate_argnames=("st",))
    def repeat_step(st, dev, reps):
        def body(_, s):
            s2, _ = dynamic_step(s, dev, tables, cfg, scale_gradient,
                                 subpixel)
            return s2
        return jax.lax.fori_loop(0, reps, body, st)

    def _copy(s):
        return jax.tree.map(lambda a: a + 0 if hasattr(a, "dtype")
                            else a, s)

    # Warm-up / compile on a copy of the state (donation-safe).
    st = _copy(state)
    st, _ = single_step(st, jax.device_put(frames[0]))
    jax.block_until_ready(st.z)

    if compute_repeats == "auto":
        # Probe both legs with the single-step path, then scale. The
        # single-step probe over-counts per-step cost when dispatch is
        # slow (each step pays a dispatch the fori_loop'd repeat avoids),
        # so a refinement pass below re-scales R from the legs as
        # actually measured at the first guess.
        st = _copy(state)
        d0 = jax.device_put(frames[0])
        jax.block_until_ready(d0)
        t0 = time.perf_counter()
        for _ in range(4):
            st, _ = single_step(st, d0)
        jax.block_until_ready(st.z)
        step_s = (time.perf_counter() - t0) / 4
        t0 = time.perf_counter()
        devs = [jax.device_put(f) for f in frames[:4]]
        jax.block_until_ready(devs)
        h2d_s = (time.perf_counter() - t0) / len(devs)
        compute_repeats = int(np.clip(round(h2d_s / max(step_s, 1e-9)),
                                      1, 1024))
        # Refine: measure the fori_loop'd compute leg at the guess and
        # re-scale so compute ~= transfer.
        reps0 = int(compute_repeats)
        if reps0 > 1:
            st = _copy(state)
            st = repeat_step(st, d0, reps0)       # compile
            jax.block_until_ready(st.z)
            st = _copy(state)
            t0 = time.perf_counter()
            for _ in range(4):
                st = repeat_step(st, d0, reps0)
            jax.block_until_ready(st.z)
            rep_s = (time.perf_counter() - t0) / 4
            # Aim compute ~= 1.5x transfer: host-clock variance
            # between the leg measurements is tens of percent, so
            # aiming at exact equality leaves leg_ratio hovering at
            # the balanced-regime boundary; overshooting keeps the
            # ratio comfortably inside it either way.
            compute_repeats = int(np.clip(
                round(1.5 * reps0 * h2d_s / max(rep_s, 1e-9)), 1, 4096))
        del devs
    reps = int(compute_repeats)

    def step(st, dev):
        if reps == 1:
            return single_step(st, dev)
        return repeat_step(st, dev, reps), None

    if reps > 1:   # compile the repeated step out of the timed region
        st = _copy(state)
        st, _ = step(st, jax.device_put(frames[0]))
        jax.block_until_ready(st.z)

    # Pure compute: pre-staged device frames.
    dev_frames = [jax.device_put(f) for f in frames]
    jax.block_until_ready(dev_frames[-1])
    st = _copy(state)
    jax.block_until_ready(st.z)
    t0 = time.perf_counter()
    for d in dev_frames:
        st, _ = step(st, d)
    jax.block_until_ready(st.z)
    compute_s = (time.perf_counter() - t0) / n
    del dev_frames

    # Pure transfer: H2D only.
    t0 = time.perf_counter()
    devs = [jax.device_put(f) for f in frames]
    jax.block_until_ready(devs)
    transfer_s = (time.perf_counter() - t0) / n
    del devs

    # Pipelined loop (the product path's structure: issue the H2D of
    # frame f+1, then run frame f's compute).
    st = _copy(state)
    jax.block_until_ready(st.z)
    t0 = time.perf_counter()
    pending = None
    for f in frames:
        dev = jax.device_put(f)
        if pending is not None:
            st, _ = step(st, pending)
        pending = dev
    st, _ = step(st, pending)
    jax.block_until_ready(st.z)
    pipelined_s = (time.perf_counter() - t0) / n

    # Strict sequential loop (what the reference does).
    st = _copy(state)
    jax.block_until_ready(st.z)
    t0 = time.perf_counter()
    for f in frames:
        d = jax.device_put(f)
        jax.block_until_ready(d)
        st, _ = step(st, d)
        jax.block_until_ready(st.z)
    sequential_s = (time.perf_counter() - t0) / n

    hidden = compute_s + transfer_s - pipelined_s
    eff = hidden / max(min(compute_s, transfer_s), 1e-12)
    leg_ratio = (min(compute_s, transfer_s)
                 / max(compute_s, transfer_s, 1e-12))
    if leg_ratio >= 0.2:
        regime = "balanced"
    elif transfer_s > compute_s:
        regime = "transfer_bound"
    else:
        regime = "compute_bound"
    return {
        "frames": n,
        "compute_ms": round(compute_s * 1e3, 3),
        "transfer_ms": round(transfer_s * 1e3, 3),
        "pipelined_ms": round(pipelined_s * 1e3, 3),
        "sequential_ms": round(sequential_s * 1e3, 3),
        "overlap_efficiency": round(max(0.0, min(1.0, eff)), 3),
        "speedup_vs_sequential": round(sequential_s
                                       / max(pipelined_s, 1e-12), 3),
        "compute_repeats": reps,
        "leg_ratio": round(leg_ratio, 3),
        "regime": regime,
    }


def run_streaming(state: TrackerState, frames: Iterable[np.ndarray],
                  tables: TriangulationTables, cfg: SystemConfig,
                  sync_every: int = 1,
                  scale_gradient: bool = True, subpixel: bool = True,
                  fetch: Optional[Callable[[FrameResult], object]] = None,
                  chunk: int = 1,
                  fetch_z: Optional[Callable[[jax.Array], object]] = None,
                  robust: bool = True
                  ) -> Tuple[TrackerState, StreamStats]:
    """Drive the streaming loop measuring per-frame wall latency.
    ``scale_gradient``/``subpixel``/``robust`` mirror dynamic_step's
    tracker flags (all False = exact reference semantics).

    ``sync_every`` = N blocks on the depth map every N frames (N=1
    measures true per-frame latency; larger N measures pipelined
    throughput where transfers hide under compute). ``fetch`` overrides
    the per-frame result consumer (default: async z host copy); pass
    e.g. ``lambda r: r`` to keep results device-resident.

    ``chunk`` > 1 switches to the chunked megastep (``stream_chunks``):
    one dispatch + one sync per K frames, for dispatch-bound hosts. ``fetch_z`` is the chunked path's result consumer, called
    with each (k, H, W) z stack (default: stays device-resident).
    Per-frame ``fetch``/``sync_every`` do not apply in chunked mode
    and raise ValueError if passed.
    """
    lat: List[float] = []
    if chunk > 1:
        if fetch is not None or sync_every != 1:
            raise ValueError(
                "chunk > 1 uses the chunked megastep: per-frame "
                "`fetch`/`sync_every` do not apply (pass `fetch_z` "
                "for the per-chunk consumer)")
        chunk_lat: List[float] = []
        chunk_sizes: List[int] = []
        t0 = time.perf_counter()
        for state, zs in stream_chunks(state, frames, tables, cfg,
                                       chunk,
                                       scale_gradient=scale_gradient,
                                       subpixel=subpixel,
                                       robust=robust):
            if fetch_z is not None:
                fetch_z(zs)
            jax.block_until_ready(state.z)
            now = time.perf_counter()
            k = int(zs.shape[0])
            chunk_lat.append(now - t0)
            chunk_sizes.append(k)
            lat.extend([(now - t0) / k] * k)
            t0 = now
        return state, StreamStats(lat, chunk_lat, chunk_sizes)

    t0 = time.perf_counter()
    last = None
    for i, (state, res) in enumerate(
            stream_frames(state, frames, tables, cfg, fetch=fetch,
                          scale_gradient=scale_gradient,
                          subpixel=subpixel, robust=robust)):
        last = res
        if (i + 1) % sync_every == 0:
            # Block on the carried state's depth (always a device
            # array, regardless of what ``fetch`` returned).
            jax.block_until_ready(state.z)
            now = time.perf_counter()
            dt = (now - t0) / sync_every
            lat.extend([dt] * sync_every)
            t0 = now
    if last is not None:
        jax.block_until_ready(state.z)
    return state, StreamStats(lat)
