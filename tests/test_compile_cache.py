"""One rule for the persistent compilation cache (slc_tpu.compile_cache):
the JAX_COMPILATION_CACHE_DIR variable when set, else <checkout>/.jax_cache."""

import os
import subprocess
import sys

import jax

from slc_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *args: calls.append(args))
    return calls


def test_env_var_set_sets_nothing(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert compile_cache.enable_compile_cache(env) == str(tmp_path)
    assert calls == []


def test_env_var_unset_uses_the_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache({}) == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_cli_run_writes_only_to_the_env_dir(tmp_path):
    """``python -m slc_tpu run`` with the variable set caches there and
    leaves <checkout>/.jax_cache untouched."""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    before = (sorted(os.listdir(compile_cache.DEFAULT_DIR))
              if os.path.isdir(compile_cache.DEFAULT_DIR) else None)
    ds, out = str(tmp_path / "ds"), str(tmp_path / "o")
    for argv in (["synth", ds, "--frames", "2", "--cam", "48x64",
                  "--pro", "48x320", "--gray-bits", "4"],
                 ["run", ds, "--calib", os.path.join(ds, "parameters.yml"),
                  "--out", out, "--out-format", "npz", "--no-clouds"]):
        r = subprocess.run([sys.executable, "-m", "slc_tpu", *argv],
                           env=env, cwd=str(tmp_path), capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    assert cache.is_dir() and any(cache.iterdir())
    after = (sorted(os.listdir(compile_cache.DEFAULT_DIR))
             if os.path.isdir(compile_cache.DEFAULT_DIR) else None)
    assert after == before
