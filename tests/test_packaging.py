"""Packaging smoke test.

Builds the wheel from pyproject.toml, installs it into a CLEAN venv (with
system site-packages for the jax/numpy runtime — no network), and drives
one full controller step from OUTSIDE the repo tree, so the test fails if
the wheel is missing modules or package data (the vendored URDF fixture).
Mirrors the reference's shipped-package role (`pyproject.toml:30-31`
there ships .so/.casadi artifacts; here the only data file is the URDF).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent

DRIVE = r"""
import sys
assert not any(p.endswith("repo") for p in sys.path if p), sys.path[:3]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import biped_pympc_tpu
# The import must come from the installed wheel, not the source tree.
assert "site-packages" in biped_pympc_tpu.__file__, biped_pympc_tpu.__file__
from biped_pympc_tpu import ControllerConf, MPCConf, MPCController, \
    recommended_conf

# Package data: the vendored URDF fixture must ship in the wheel and parse.
from biped_pympc_tpu.models import urdf
import os
assert os.path.exists(urdf.T1_FIXTURE_URDF), urdf.T1_FIXTURE_URDF
chain = urdf.chain_from_urdf(
    urdf.T1_FIXTURE_URDF, "Trunk", "left_foot_sole_link", locked=("Waist",))

ctrl = MPCController(
    ControllerConf(), MPCConf(verbose=False, solver="ric_aug",
                              newton_iterations=4),
    num_envs=2, gait_id=2)
obs = np.zeros((2, 43), np.float32)
obs[:, 2] = 0.55
obs[:, 3] = 1.0
q0 = [0.0, 0.0, 0.45, -0.9, 0.45]
obs[:, 13:18] = q0
obs[:, 18:23] = q0
ctrl.set_command(np.tile([0.3, 0.0, 0.0], (2, 1)).astype(np.float32),
                 np.full(2, 0.55, np.float32))
ctrl.update_state(obs)
ctrl.run_mpc()
ctrl.run_lowlevel()
tau = np.asarray(ctrl.get_action())
assert tau.shape == (2, 10) and np.isfinite(tau).all()
print("INSTALLED-PACKAGE DRIVE OK", float(np.abs(tau).max()))
"""


def test_wheel_builds_installs_and_drives(tmp_path):
    wheel_dir = tmp_path / "wheels"
    # Build the wheel offline (no build isolation: setuptools is ambient).
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-w", str(wheel_dir), str(REPO)],
        check=True, capture_output=True, text=True)
    wheels = list(wheel_dir.glob("biped_pympc_tpu-*.whl"))
    assert len(wheels) == 1, list(wheel_dir.iterdir())

    venv_dir = tmp_path / "venv"
    subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages",
         str(venv_dir)],
        check=True, capture_output=True, text=True)
    vpy = venv_dir / "bin" / "python"
    subprocess.run(
        [str(vpy), "-m", "pip", "install", "--no-deps", "--no-index",
         str(wheels[0])],
        check=True, capture_output=True, text=True)

    # Drive from a neutral cwd so the source tree cannot shadow the wheel.
    # The ambient interpreter is itself a venv, so --system-site-packages
    # does not chain to it; the jax/numpy runtime is supplied via
    # PYTHONPATH (which contains no biped_pympc_tpu — the wheel's copy is
    # the only one, asserted inside DRIVE).
    import sysconfig

    ambient_site = sysconfig.get_paths()["purelib"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ambient_site
    out = subprocess.run(
        [str(vpy), "-c", DRIVE], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "INSTALLED-PACKAGE DRIVE OK" in out.stdout, out.stdout

    # The repo-root bench CLI parses its arguments (DEPLOY.md's entry).
    out2 = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--help"],
        capture_output=True, text=True, timeout=120,
        env={**env, "JAX_PLATFORMS": "cpu"})
    assert out2.returncode == 0, out2.stderr[-1000:]
