"""Worker process for tests/test_multiprocess.py.

Each process joins a real `jax.distributed` CPU cluster (the SLC_* env
contract of slc_tpu.parallel.launch), builds the global scan x tile
mesh, feeds its local scan shard through `shard_host_batch`, runs one
`tiled_batched_dynamic_step` (whose metrics psum crosses the process
boundary), and checks every locally-addressable output shard against
the single-device golden computed in-process. Writes a JSON verdict to
$SLC_OUT.

The reference has no multi-process equivalent (single Windows process,
DynaFrame/main.cpp:42-45); this exercises the BASELINE.md 2-host
scaling path on CPU, per SURVEY.md §4 item (4).
"""

import json
import os
import sys
import time
import traceback

# Backend setup must precede the jax import. The worker always runs on
# the CPU (one virtual-device group per process, stitched by
# jax.distributed): several workers share one host, and on a GPU host
# each would otherwise open the same card.
os.environ["JAX_PLATFORMS"] = "cpu"
_n_local = int(os.environ.get("SLC_LOCAL_DEVICES", "4"))
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags
        + f" --xla_force_host_platform_device_count={_n_local}").strip()

import numpy as np
import jax

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slc_tpu import synth
from slc_tpu.calib import synthetic_calibration, build_tables
from slc_tpu.config import SystemConfig
from slc_tpu.dynamic import TrackerState, dynamic_step, init_tracker
from slc_tpu.parallel import launch, tiled_batched_dynamic_step
from slc_tpu.parallel.mesh import SCAN, TILE_X, TILE_Y

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                   gray_bits=5, phase_steps=4)


def main() -> dict:
    ctx = launch.initialize()          # SLC_COORDINATOR/NUM_PROCESSES/ID
    mesh = launch.global_tile_mesh(scan=ctx.process_count)
    n_scans = mesh.shape[SCAN]

    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w)

    # Deterministic, per-scan-distinct data rendered identically on every
    # process: scan s is a plane at z0 = 48 + 2 s moving between frames.
    frame0s, frame1s = [], []
    golden_states = []
    for s in range(n_scans):
        frames, zs, pus = synth.render_dynamic_sequence(
            calib, CFG, 2, z0=48.0 + 2.0 * s, dz_per_frame=0.5,
            stripe_period=12)
        frame0s.append(frames[0])
        frame1s.append(frames[1])
        st = init_tracker(
            jnp.asarray(frames[0]), jnp.asarray(pus[0], jnp.float32),
            jnp.asarray(zs[0], jnp.float32), CFG)
        # Snapshot to host: dynamic_step donates (and deletes) its state
        # argument, and the leaves are needed again to build the
        # distributed inputs.
        golden_states.append(jax.tree.map(np.asarray, st))

    # Golden: the plain single-device step per scan (no sharding).
    golden_z, golden_pu, golden_valid = [], [], []
    for s in range(n_scans):
        st_dev = jax.tree.map(jnp.asarray, golden_states[s])
        _, ref = dynamic_step(st_dev, jnp.asarray(frame1s[s]), tables, CFG)
        golden_z.append(np.asarray(ref.z))
        golden_pu.append(np.asarray(ref.proj_u))
        golden_valid.append((np.asarray(ref.z) > 0).mean())
    golden_z = np.stack(golden_z)
    golden_pu = np.stack(golden_pu)
    golden_valid_frac = float(np.mean(golden_valid))

    # Distributed inputs: each process contributes only its scan rows.
    sl = launch.local_scan_slice(mesh, n_scans)
    s3 = P(SCAN, TILE_Y, TILE_X)

    def shard3(stack_np: np.ndarray) -> jax.Array:
        return launch.shard_host_batch(
            mesh, s3, np.ascontiguousarray(stack_np[sl]))

    def stack_states() -> TrackerState:
        leaves = {}
        for name in ("proj_u", "strip_w", "strip_b", "z"):
            full = np.stack([getattr(golden_states[s], name)
                             for s in range(n_scans)])
            leaves[name] = shard3(full)
        idx = np.stack([golden_states[s].frame_idx
                        for s in range(n_scans)])
        leaves["frame_idx"] = launch.shard_host_batch(
            mesh, P(SCAN), np.ascontiguousarray(idx[sl]))
        return TrackerState(**leaves)

    states = stack_states()
    frames_g = shard3(np.stack(frame1s))

    # Cross-process collective sanity: a global reduction over the
    # sharded input must equal the host-side sum of ALL scans.
    total = float(jax.jit(jnp.sum)(frames_g.astype(jnp.float32)))
    expect_total = float(np.stack(frame1s).astype(np.float64).sum())

    new_states, results, metrics = tiled_batched_dynamic_step(
        states, frames_g, tables, CFG, mesh)
    jax.block_until_ready(new_states.z)

    # Check every locally-addressable shard against the golden.
    max_z_err = 0.0
    max_pu_err = 0.0
    n_shards = 0
    for arr, golden in ((new_states.z, golden_z),
                        (results.proj_u, golden_pu)):
        for shard in arr.addressable_shards:
            got = np.asarray(shard.data)
            want = golden[shard.index]
            err = float(np.max(np.abs(got - want))) if got.size else 0.0
            if golden is golden_z:
                max_z_err = max(max_z_err, err)
            else:
                max_pu_err = max(max_pu_err, err)
            n_shards += 1

    valid_frac = float(metrics["valid_frac"])

    # Cross-PROCESS coverage of the other flagship tiled paths: the
    # heterodyne decode (pointwise, psum-free) and the multigrid
    # spatial unwrap, whose V-cycle all_gathers its coarse levels —
    # that collective crossing REAL process boundaries is exactly what
    # in-process virtual-device tests cannot certify. Skipped in the
    # weak-scaling bench mode (SLC_BENCH_FRAMES), where only the timed
    # loop matters and the extra compiles would slow every cluster.
    bench_frames = int(os.environ.get("SLC_BENCH_FRAMES", "0"))
    het_err = unwrap_err = None
    if not bench_frames:
        from slc_tpu.config import HeterodyneConfig
        from slc_tpu.parallel import (tiled_heterodyne_decode,
                                      tiled_unwrap_spatial)
        from slc_tpu.pipeline import decode_heterodyne_frame
        from slc_tpu.ops.unwrap_spatial import unwrap_spatial
        from jax.sharding import NamedSharding

        het = HeterodyneConfig()
        fr_imgs, _, _ = synth.render_fringe_stack(
            calib, CFG, synth.plane_surface(55.0, 0.1, 0.05),
            het.periods(CFG.pro_w), het.phase_steps, noise_sigma=1.0)
        ref_het = decode_heterodyne_frame(jnp.asarray(fr_imgs), tables,
                                          CFG, het)
        spec3 = NamedSharding(mesh, P(None, TILE_Y, TILE_X))
        imgs_g = jax.make_array_from_process_local_data(
            spec3, np.ascontiguousarray(fr_imgs))
        got_het = tiled_heterodyne_decode(imgs_g, tables, CFG, het, mesh)
        het_err = 0.0
        for shard in got_het.z.addressable_shards:
            want = np.asarray(ref_het.z)[shard.index]
            got = np.asarray(shard.data)
            if got.size:
                het_err = max(het_err,
                              float(np.max(np.abs(got - want))))

        t_unwrap = 24.0
        xs = (np.linspace(0, 5 * t_unwrap, CFG.cam_w)[None, :]
              + 0.4 * np.arange(CFG.cam_h)[:, None]).astype(np.float32)
        psi = np.mod(xs, t_unwrap).astype(np.float32)
        ref_unwrap = np.asarray(unwrap_spatial(
            jnp.asarray(psi), t_unwrap, max_iters=200,
            anchor=jnp.asarray(xs)))
        spec2 = NamedSharding(mesh, P(TILE_Y, TILE_X))
        psi_g = jax.make_array_from_process_local_data(spec2, psi)
        anc_g = jax.make_array_from_process_local_data(spec2, xs)
        got_unwrap = tiled_unwrap_spatial(psi_g, t_unwrap, mesh,
                                          max_iters=200, anchor=anc_g)
        unwrap_err = 0.0
        for shard in got_unwrap.addressable_shards:
            want = ref_unwrap[shard.index]
            got = np.asarray(shard.data)
            if got.size:
                unwrap_err = max(unwrap_err,
                                 float(np.max(np.abs(got - want))))

    # Optional weak-scaling measurement (VERDICT r2 item 2): constant
    # per-process work (1 scan x a fixed tile grid per process), wall
    # time of the steady-state distributed step loop. Efficiency at N
    # processes = t(1 proc) / t(N procs); each step's psum + halo
    # ppermute synchronize the cluster, so per-rank wall times agree.
    bench_s = None
    if bench_frames:
        st = new_states
        st, _, _ = tiled_batched_dynamic_step(st, frames_g, tables,
                                              CFG, mesh)   # warm (cached)
        jax.block_until_ready(st.z)
        t0 = time.perf_counter()
        for _ in range(bench_frames):
            st, _, _ = tiled_batched_dynamic_step(st, frames_g, tables,
                                                  CFG, mesh)
        jax.block_until_ready(st.z)
        bench_s = (time.perf_counter() - t0) / bench_frames

    res = {
        "process_index": ctx.process_index,
        "process_count": ctx.process_count,
        "n_global_devices": len(ctx.global_devices),
        "n_local_devices": len(ctx.local_devices),
        "local_scan_slice": [sl.start, sl.stop],
        "n_local_shards_checked": n_shards,
        "max_z_err": max_z_err,
        "max_pu_err": max_pu_err,
        "valid_frac": valid_frac,
        "golden_valid_frac": golden_valid_frac,
        "sum_err": abs(total - expect_total),
        "bench_s_per_frame": bench_s,
        "het_err": het_err,
        "unwrap_err": unwrap_err,
        "ok": (max_z_err < 1e-3 and max_pu_err < 1e-4
               and abs(valid_frac - golden_valid_frac) < 1e-5
               and abs(total - expect_total) < 1e-2
               and n_shards == 2 * len(ctx.local_devices)
               and (het_err is None or het_err < 1e-4)
               and (unwrap_err is None or unwrap_err < 1e-3)),
    }
    return res


if __name__ == "__main__":
    out = os.environ["SLC_OUT"]
    try:
        res = main()
    except Exception:
        res = {"ok": False, "error": traceback.format_exc()}
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    sys.exit(0 if res.get("ok") else 1)
