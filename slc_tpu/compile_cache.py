"""Where compiled XLA programs are cached between processes.

Every entry point (``python -m slc_tpu``, ``bench.py``, ``chip_smoke.py``
and the tests' card mode) calls :func:`enable_compile_cache` once, so all
of them share one rule:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself and
  nothing is set in code;
* otherwise the cache is ``<checkout>/.jax_cache``. The path is fixed
  because it is part of each entry's key: a directory that moved would
  never hit.
"""

from __future__ import annotations

import os
from typing import Mapping

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache(environ: Mapping[str, str] = os.environ) -> str:
    """Apply the rule above; call before the first compilation. Returns
    the cache directory."""
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
