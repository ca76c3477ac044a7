"""Dense per-pixel kernels as jit/XLA functions.

These are the only implementations: XLA compiles the same code for the
GPU and for the CPU the tests run on.
"""

from slc_tpu.ops.phase import decode_phase, phase_sincos, modulation
from slc_tpu.ops.gray import decode_gray, gray_to_binary, binary_to_gray
from slc_tpu.ops.unwrap import gray_assisted_merge, heterodyne_unwrap
from slc_tpu.ops.triangulate import triangulate_depth, backproject
from slc_tpu.ops.stripe import stripe_regression, box_sum_vertical
from slc_tpu.ops.filters import box_blur_3x3, bilateral_filter

__all__ = [
    "decode_phase", "phase_sincos", "modulation",
    "decode_gray", "gray_to_binary", "binary_to_gray",
    "gray_assisted_merge", "heterodyne_unwrap",
    "triangulate_depth", "backproject",
    "stripe_regression", "box_sum_vertical",
    "box_blur_3x3", "bilateral_filter",
]
