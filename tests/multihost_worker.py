"""Worker for the 2-process multi-host test (see test_multihost.py).

Each process owns 4 virtual CPU devices; the global mesh is 8 devices over
2 processes — the env batch shards across BOTH, so the `pmean` metric in
`shard_map_step` crosses the process boundary (the DCN path of a real
multi-host deployment; here Gloo). Every process also computes the full
batch un-sharded locally and checks its addressable shards against it, so
the test verifies numerical equality, not just liveness.

Usage: multihost_worker.py <process_id> <num_processes> <coordinator>
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(
    coordinator_address=coord, num_processes=nproc, process_id=pid
)

import numpy as np
import jax.numpy as jnp

from biped_pympc_tpu import ControllerConf, MPCConf
from biped_pympc_tpu.control.controller import BipedControllerCore
from biped_pympc_tpu.parallel import mesh as pmesh

B = 16
cfg = ControllerConf()
core = BipedControllerCore(cfg, MPCConf(solver="tridiag_aug"), gait_id=2)

# Deterministic global inputs (identical on every process).
rng = np.random.default_rng(0)
dof = core.num_dof
obs = np.zeros((B, 13 + 6 * dof), dtype=np.float32)
obs[:, 2] = 0.55
obs[:, 3] = 1.0
q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], dtype=np.float32)
obs[:, 13: 13 + dof] = q0 + rng.uniform(-0.03, 0.03, (B, dof)).astype(np.float32)
obs[:, 13 + dof: 13 + 2 * dof] = q0
twist = np.zeros((B, 3), np.float32)
twist[:, 0] = 0.2
height = np.full((B,), 0.55, np.float32)

# Single-process reference on this process's devices (no sharding).
state0 = core.init_state(B)
_, tau_ref, out_ref = core.control_step(
    state0, jnp.asarray(obs), jnp.asarray(twist), jnp.asarray(height)
)
tau_ref = np.asarray(tau_ref)
cost_ref = float(np.mean(np.asarray(out_ref.cost)))

# Global mesh across both processes; shard all inputs on the batch axis.
mesh = pmesh.make_mesh(jax.devices())
sharding = pmesh.batch_sharding(mesh)


def to_global(arr):
    """Build a globally-sharded array from this process's local rows."""
    return jax.make_array_from_process_local_data(sharding, np.asarray(arr))


local = slice(pid * B // nproc, (pid + 1) * B // nproc)
state_g = jax.tree.map(
    lambda a: to_global(np.asarray(a)[local]), core.init_state(B)
)
step = pmesh.shard_map_step(
    lambda st, o, tw, h: core.control_step(st, o, tw, h), mesh
)
_, tau_g, _, mean_cost = step(
    state_g, to_global(obs[local]), to_global(twist[local]),
    to_global(height[local]),
)

# Verify this process's addressable shards against the local reference.
for shard in tau_g.addressable_shards:
    start = shard.index[0].start or 0
    got = np.asarray(shard.data)
    want = tau_ref[start: start + got.shape[0]]
    np.testing.assert_allclose(got, want, atol=1e-5)
np.testing.assert_allclose(float(mean_cost), cost_ref, rtol=1e-5)
print(f"MULTIHOST_OK pid={pid} devices={len(jax.devices())} "
      f"mean_cost={float(mean_cost):.4f}", flush=True)

# ---------------------------------------------------------------------
# Phase 2: the fused solver on the same 2-process global mesh.
# `controller_step` routes it through shard_map, so each process's devices
# run the kernel (its CPU target here) on exactly their batch shards, and
# the only cross-process traffic is the pmean metric.
# ---------------------------------------------------------------------
core_f = BipedControllerCore(
    cfg, MPCConf(solver="fused_ric_aug", verbose=False), gait_id=2
)
# Fewer Newton iterations keep the worker quick; the sharded program
# structure under test is iteration-count-independent.
core_f.opts = core_f.opts._replace(iterations=4)

_, tau_ref_f, out_ref_f = core_f.control_step(
    core_f.init_state(B), jnp.asarray(obs), jnp.asarray(twist),
    jnp.asarray(height)
)
tau_ref_f = np.asarray(tau_ref_f)
cost_ref_f = float(np.mean(np.asarray(out_ref_f.cost)))

state_gf = jax.tree.map(
    lambda a: to_global(np.asarray(a)[local]), core_f.init_state(B)
)
step_f = pmesh.controller_step(core_f, mesh, with_metrics=True)
_, tau_gf, _, mean_cost_f = step_f(
    state_gf, to_global(obs[local]), to_global(twist[local]),
    to_global(height[local]),
)
for shard in tau_gf.addressable_shards:
    start = shard.index[0].start or 0
    got = np.asarray(shard.data)
    want = tau_ref_f[start: start + got.shape[0]]
    np.testing.assert_allclose(got, want, atol=1e-5)
np.testing.assert_allclose(float(mean_cost_f), cost_ref_f, rtol=1e-5)
print(f"MULTIHOST_FUSED_OK pid={pid} devices={len(jax.devices())} "
      f"mean_cost={float(mean_cost_f):.4f}", flush=True)
