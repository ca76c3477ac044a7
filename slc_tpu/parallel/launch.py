"""Multi-host launcher: bootstrap `jax.distributed` and build global meshes.

The reference is a single Windows process (DynaFrame/main.cpp:42-45); it has
no launcher to mirror. This is the north-star multi-host entry point from
SURVEY.md §7 (layer 9): one process per host, `jax.distributed.initialize`
to join the cluster, then a global `Mesh` whose SCAN axis spans hosts and
whose tile axes stay within one host's cards.

Usage, one process per host::

    from slc_tpu.parallel import launch
    ctx = launch.initialize()              # env-driven, or pass explicitly
    mesh = launch.global_tile_mesh(scan=ctx.process_count)
    batch = launch.shard_host_batch(mesh, P("scan"), local_scans)

Environment variables (set all three for a multi-process run; nothing in
a GPU or CPU cluster tells JAX of the cluster otherwise):

* ``SLC_COORDINATOR``   — ``host:port`` of process 0,
* ``SLC_NUM_PROCESSES`` — total process count,
* ``SLC_PROCESS_ID``    — this process's rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from slc_tpu.parallel.mesh import SCAN, TILE_X, TILE_Y, tile_mesh

_INITIALIZED = False


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What a process needs to know about the cluster it joined."""

    process_index: int
    process_count: int
    local_devices: Tuple[jax.Device, ...]
    global_devices: Tuple[jax.Device, ...]

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> DistributedContext:
    """Join (or stand alone as) a JAX cluster and describe it.

    Resolution order for each argument: explicit parameter, then the
    ``SLC_*`` environment variable.
    A plain single-process run — nothing passed, nothing in the
    environment, single-host backend — skips `jax.distributed` entirely,
    so all tests and the single-chip benchmark go through this same
    entry point.

    Safe to call more than once; later calls return the current cluster
    description without re-initializing.
    """
    global _INITIALIZED

    coordinator_address = (coordinator_address
                           or os.environ.get("SLC_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("SLC_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("SLC_PROCESS_ID")
        process_id = int(env) if env else None

    multi = (coordinator_address is not None or (num_processes or 1) > 1
             or _INITIALIZED)
    if multi and not _INITIALIZED:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        _INITIALIZED = True

    return DistributedContext(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=tuple(jax.local_devices()),
        global_devices=tuple(jax.devices()))


def global_tile_mesh(scan: Optional[int] = None,
                     tiles: Optional[Tuple[int, int]] = None) -> Mesh:
    """A (scan, ty, tx) mesh over every device in the cluster.

    By default the SCAN axis gets one slot per process, so scan-level data
    parallelism crosses hosts while the (ty, tx) image tiles — and their
    `ppermute` halo traffic — stay on the cards of one host.
    """
    if scan is None:
        scan = jax.process_count()
    return tile_mesh(jax.devices(), scan=scan, tiles=tiles)


def shard_host_batch(mesh: Mesh, spec: PartitionSpec,
                     local_data: np.ndarray) -> jax.Array:
    """Assemble a global array from per-process local shards.

    Each process passes only the rows of the leading (scan) axis it owns;
    `jax.make_array_from_process_local_data` stitches them into one global
    jax.Array laid out by ``spec`` without gathering to any single host —
    the multi-host feed path for scan-parallel reconstruction.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_data)


def local_scan_slice(mesh: Mesh, total_scans: int) -> slice:
    """Which rows of the global scan axis this process should load.

    Mirrors the contiguous block layout `shard_host_batch` expects: the
    scan axis is split evenly over `mesh.shape[SCAN]` groups, and each
    process owns the groups its local devices sit in.
    """
    n_groups = mesh.shape[SCAN]
    if total_scans % n_groups:
        raise ValueError(
            f"{total_scans} scans not divisible by scan axis {n_groups}")
    per_group = total_scans // n_groups
    dev_grid = np.asarray(mesh.devices)  # (scan, ty, tx)
    local = {d.id for d in jax.local_devices()}
    groups = [g for g in range(n_groups)
              if any(d.id in local for d in dev_grid[g].ravel())]
    if not groups:
        raise RuntimeError("this process owns no devices in the mesh")
    lo, hi = min(groups), max(groups)
    if groups != list(range(lo, hi + 1)):
        raise RuntimeError("local scan groups are not contiguous; "
                           "reorder devices when building the mesh")
    return slice(lo * per_group, (hi + 1) * per_group)


__all__ = ["DistributedContext", "initialize", "global_tile_mesh",
           "shard_host_batch", "local_scan_slice",
           "SCAN", "TILE_Y", "TILE_X"]
