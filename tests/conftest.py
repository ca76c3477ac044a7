"""Test environment. Must run before jax is imported.

By default the tests run on the CPU backend with 8 virtual devices, so
the sharding / halo-exchange / psum paths run without a GPU mesh, and
tests marked ``gpu`` skip.

SLC_TEST_GPU=1 keeps the real backend instead (card mode): the ``gpu``
tests then run on the card and everything else runs single-device.
Card mode is one process: pytest-xdist workers would each open the card,
and a second JAX process on a card fails for want of memory.
``python chip_smoke.py`` runs the ``gpu`` tests in card mode.
"""

import os

_ON_CARD = os.environ.get("SLC_TEST_GPU", "") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import jax  # noqa: E402  (after env setup)

if _ON_CARD:
    from slc_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, never at import:
    every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; run on the card with "
                    "`python chip_smoke.py`")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
