"""Device-mesh construction for structured-light workloads.

Axes (SURVEY.md §2 parallelism table):

* ``SCAN`` — data parallelism over independent scans / streaming batches
  (the axis that spans hosts at scale),
* ``TILE_Y`` / ``TILE_X`` — image-tile parallelism (the sequence-parallel
  analog): each device owns an (H/ty, W/tx) block of the camera image;
  windowed ops exchange <=11-px halos with their neighbors
  (halo widths set by RECO_WINDOW_SIZE=21, StaticParameters.cpp:38, and
  the 3x3 blur, CCalculation.cpp:650).

The mesh is a plain reshape of the device list: the cards of one host are
joined all to all (NVLink), so no device order is better than another.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh

SCAN = "scan"
TILE_Y = "ty"
TILE_X = "tx"


def _near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n = a*b with a <= b and a maximal (closest to sqrt)."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def tile_mesh(devices: Optional[Sequence[jax.Device]] = None,
              scan: int = 1,
              tiles: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build a (scan, ty, tx) mesh over ``devices``.

    With ``tiles`` unspecified, the per-scan device count is factored
    near-square, with the larger factor on ``tx``: camera images are
    wider than tall, so this keeps the tiles near-square and the halo
    bytes per tile small.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % scan:
        raise ValueError(f"{n} devices not divisible by scan={scan}")
    per_scan = n // scan
    if tiles is None:
        ty, tx = _near_square_factors(per_scan)
    else:
        ty, tx = tiles
        if ty * tx != per_scan:
            raise ValueError(
                f"tiles {ty}x{tx} != devices-per-scan {per_scan}")
    import numpy as np
    arr = np.array(devices).reshape(scan, ty, tx)
    return Mesh(arr, (SCAN, TILE_Y, TILE_X))


def tile_counts(mesh: Mesh) -> Tuple[int, int]:
    """(ty, tx) tile grid of a mesh built by :func:`tile_mesh`."""
    return mesh.shape[TILE_Y], mesh.shape[TILE_X]
