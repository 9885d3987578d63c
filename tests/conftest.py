"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Tests run on a virtual 8-device CPU mesh so multi-device sharding is
exercised without accelerators. float64 is enabled so solver tests can
compare against the float64 golden reference
(`biped_pympc_tpu/ops/reference_pdipm.py`) at tight tolerance.

Tests marked `gpu` need an NVIDIA card and skip without one (the `gpu`
fixture decides at run time). On the card they run with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`; any other run
keeps the CPU backend, which is the default here.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "bench")]

import jax  # noqa: E402

# Apply the platform to the live config too, in case jax was imported
# before this file set the environment variable.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/ on the card")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound in-process compile-cache growth across the suite.

    jaxlib 0.9.0's CPU backend segfaults deterministically inside
    backend_compile_and_load once a single pytest process has accumulated
    roughly the full suite's compilations (reproduced twice at the same
    position with different victim tests; each victim passes standalone).
    Dropping the executables between modules keeps the process under the
    threshold. Costs recompiles for cross-module duplicate shapes — the
    suite has few, so the overhead is small relative to a crash.
    """
    yield
    jax.clear_caches()
