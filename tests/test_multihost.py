"""True multi-process "multi-host" test: 2 JAX processes, one global mesh.

The reference has no distributed capability at all (SURVEY.md section 2);
this framework's scaling design shards the env batch over every chip of a
mesh. The in-process tests cover the 8-virtual-device single-process case;
here two OS processes (4 virtual CPU devices each) form one 8-device global
mesh via `jax.distributed` — collectives (the `pmean` metric) cross the
process boundary over Gloo. Each worker checks its
addressable output shards against a locally-computed un-sharded reference
(`multihost_worker.py`).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.slow  # integration tier: pytest -m slow

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=str(ROOT),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "multihost_worker.py"),
             str(pid), "2", coord],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid} devices=8" in out, out[-3000:]
        # The fused solver on the same global mesh (shard_map route, its
        # CPU target on the CPU devices).
        assert f"MULTIHOST_FUSED_OK pid={pid} devices=8" in out, out[-3000:]
