"""chip_smoke.py refuses to report a result without a GPU, alone or
beside the package, and its one-card phases hold at small sizes."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(script, *args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script, *args], env=env,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_on_the_cpu_backend(tmp_path, alone):
    script = SCRIPT
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    r = _run(script, cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr and "'cpu'" in r.stderr


def _load_script():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: The phases' own sizes cut to what a CPU test can afford.
SMALL = dict(cam="192x256", pro="160x640", frames=5, fringe_frames=2,
             h2mp=96, w2mp=160, scans=4, landmarks=32)


@pytest.mark.parametrize("phase", ["run_locked", "run_heterodyne",
                                   "run_spatial", "step_parity", "fusion"])
def test_phase_passes_at_small_size(tmp_path, phase):
    """Each one-card phase, called directly at small sizes on the CPU: its
    checks hold and its record carries the measurements it checks."""
    import jax
    smoke = _load_script()
    fn = getattr(smoke, "phase_" + phase)
    args = {"run_locked": (str(tmp_path), SMALL),
            "run_heterodyne": (str(tmp_path), SMALL),
            "run_spatial": (str(tmp_path), SMALL),
            "step_parity": (SMALL,),
            "fusion": (jax, SMALL)}[phase]
    rec = {}
    fn(rec, *args)
    assert rec["tolerances"]
    want = {"run_locked": ("frame0_rmse", "terminal_drift_median",
                           "frame0_valid", "terminal_valid"),
            "run_heterodyne": ("rmse", "valid"),
            "run_spatial": ("rmse", "valid"),
            "step_parity": ("step_pu_max_abs_diff", "heterodyne_rmse"),
            "fusion": ("ate", "pose_delta_vs_host_cpu")}[phase]
    for k in want:
        assert np.isfinite(rec[k]), (k, rec)
