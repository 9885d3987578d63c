"""Persistent compilation cache placement (`utils/cache.py`)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from biped_pympc_tpu.utils.cache import enable_compilation_cache
d = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.ones(3)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env_extra)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return out.stdout.split()[-2:]


def test_cache_lands_in_the_environment_directory(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no other
    directory and compiled programs land there."""
    cache = str(tmp_path / "cc")
    returned, configured = _probe({"JAX_COMPILATION_CACHE_DIR": cache})
    assert returned == configured == cache
    assert os.listdir(cache), "no cache entry written"


def test_cache_defaults_to_repo_directory():
    """Without the variable the cache stays at the fixed repo path."""
    returned, configured = _probe({})
    assert returned == configured == os.path.join(ROOT, ".jax_cache")
