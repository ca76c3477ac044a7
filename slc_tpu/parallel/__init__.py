"""Multi-device scaling: image-tile parallelism with halo exchange.

The reference is single-threaded C++ with zero distribution (SURVEY.md §2,
"Parallelism & distribution inventory"); every strategy here is new:

* ``mesh``     — device-mesh construction (scan/data axis × image tiles),
* ``halo``     — `ppermute` neighbor exchange for windowed stencils,
* ``tiled``    — `shard_map` versions of the pipeline stages.

Collectives are XLA's (NCCL on GPUs: every card reaches every other at
one NVLink rate); no hand-written transport.
"""

from slc_tpu.parallel.mesh import tile_mesh, TILE_Y, TILE_X, SCAN
from slc_tpu.parallel import launch
from slc_tpu.parallel.halo import halo_exchange, halo_crop
from slc_tpu.parallel.tiled import (
    tiled_absolute_decode,
    tiled_heterodyne_decode,
    tiled_stripe_regression,
    tiled_dynamic_step,
    tiled_batched_dynamic_step,
    shard_image,
)
from slc_tpu.parallel.unwrap_tiled import tiled_unwrap_spatial

__all__ = [
    "tile_mesh", "TILE_Y", "TILE_X", "SCAN", "launch",
    "halo_exchange", "halo_crop",
    "tiled_absolute_decode", "tiled_heterodyne_decode",
    "tiled_stripe_regression", "tiled_dynamic_step",
    "tiled_batched_dynamic_step", "tiled_unwrap_spatial", "shard_image",
]
