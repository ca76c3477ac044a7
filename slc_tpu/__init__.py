"""slc_tpu — a structured-light depth engine in JAX.

A JAX/XLA framework with the capabilities of the reference
DynaFrame pipeline (structured-light 3D reconstruction for dynamic scenes:
Gray-code + N-step phase-shift decoding, temporal/multi-frequency/spatial
phase unwrapping, projector-camera triangulation, per-frame stripe tracking)
re-designed for an accelerator:

* the functional core is pure jit-compiled kernels ``(images, calib, state)
  -> (depth, state)`` in float32, which XLA fuses for the GPU,
* multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with image
  tiles and ``ppermute`` halo exchange (no hand-written transport),
* multi-scan fusion runs distributed Gauss-Newton/Schur bundle adjustment
  over ``psum`` collectives.

Reference behavior citations point into ``/root/reference`` (DynaFrame) as
``DynaFrame/<file>:<line>``.
"""

from slc_tpu.config import SystemConfig, REFERENCE_CONFIG
from slc_tpu.calib import Calibration, TriangulationTables

__version__ = "0.1.0"

__all__ = [
    "SystemConfig",
    "REFERENCE_CONFIG",
    "Calibration",
    "TriangulationTables",
]
