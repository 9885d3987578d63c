"""Multi-device scaling: env-batch sharding over a 1-D device mesh.

The reference is single-process single-GPU (`SURVEY.md` section 2: no
distributed backend exists to port). Here the environment batch is the
parallel axis: it is sharded across every device with `jax.sharding`, all
per-env state stays resident (sharded the same way), and only scalar metrics
are reduced with `pmean`-style collectives. The cards of one host are joined
all to all, so the mesh is 1-D over `jax.devices()`.

Because each env's MPC solve is independent, the sharded step has zero
inter-device communication in the hot path — the collectives appear only in
`metrics_summary` and the `with_metrics` step, so scaling is linear by
construction and the design goal is per-device throughput.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices with the env-batch axis."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env-batch) axis; replicate nothing else."""
    return NamedSharding(mesh, P(DATA_AXIS))


def shard_state(state: Any, mesh: Mesh) -> Any:
    """Place every leaf of a controller-state pytree with its batch axis
    sharded across the mesh."""
    sharding = batch_sharding(mesh)

    def place(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(place, state)


def sharded_step(step_fn, mesh: Mesh):
    """Wrap a batched pure step (state, *args) -> out so inputs/outputs keep
    batch-axis sharding. jit + sharding constraints: XLA partitions the whole
    step SPMD across the mesh; no collectives are introduced because the
    computation is element-wise in the batch axis."""
    sharding = batch_sharding(mesh)

    @functools.wraps(step_fn)
    def wrapped(state, *args):
        state = jax.lax.with_sharding_constraint(state, sharding)
        return step_fn(state, *args)

    return jax.jit(wrapped)


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """`jax.shard_map` with VMA checking off — required for bodies that
    contain a foreign-function call (`ops/pdipm_fused.py`), whose outputs
    carry no varying-axes metadata."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def shard_map_step(step_fn, mesh: Mesh, with_metrics: bool = True):
    """Explicit-SPMD wrapper via `shard_map`: each device runs `step_fn` on
    its shard of the env batch (all pytree leaves split on their leading
    axis). Because per-env MPC solves are independent, the step body contains
    no collectives; the global mean cost is reduced with `pmean` when
    `with_metrics` (the only cross-device traffic in the system).

    step_fn: (state, *args) -> (state, tau, mpc_out) with mpc_out.cost a
    per-env (local_B,) array whose global mean is returned alongside.
    Complements `sharded_step` (the GSPMD variant) with the collectives
    spelled out.
    """
    spec = P(DATA_AXIS)

    def body(state, *args):
        out = step_fn(state, *args)
        if not with_metrics:
            return out
        new_state, tau, mpc_out = out
        global_mean_cost = jax.lax.pmean(
            jnp.mean(mpc_out.cost), axis_name=DATA_AXIS
        )
        return new_state, tau, mpc_out, global_mean_cost

    out_specs = (spec, spec, spec, P()) if with_metrics else spec
    return jax.jit(shard_map_compat(body, mesh, spec, out_specs))


def controller_step(core, mesh: Mesh, with_metrics: bool = False):
    """The sharded control step for a `BipedControllerCore`.

    Pure-JAX solver backends go through GSPMD (`sharded_step`) when
    `with_metrics=False`: the whole step is elementwise in the batch axis,
    so XLA partitions it with zero collectives (checked on the compiled HLO
    by `chip_smoke.py --four-cards` and `__graft_entry__.dryrun_multichip`).
    With `with_metrics=True` every backend routes through `shard_map` — the
    `pmean` metric reduction needs a named mesh axis.

    The fused solver ("fused_ric_aug") always goes through `shard_map`: its
    foreign-function call has no GSPMD partitioning rule, so under a plain
    sharding constraint XLA would gather the batch and run the kernel at
    FULL batch on every device. The per-device `shard_map` body runs it on
    the local shard by construction (pinned by
    `tests/test_pdipm_fused.py::test_fused_shard_map_matches_single_device`).
    """
    fn = lambda st, o, tw, h: core.control_step(st, o, tw, h)
    if with_metrics or core.solver == "fused_ric_aug":
        return shard_map_step(fn, mesh, with_metrics=with_metrics)
    return sharded_step(fn, mesh)


def count_collectives(hlo_text: str) -> int:
    """Cross-device collective ops in a compiled HLO module's text (the
    hot-path contract is zero)."""
    return sum(hlo_text.count(op) for op in
               ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all"))


def metrics_summary(values: jnp.ndarray, mesh: Mesh):
    """Global scalar metrics over a sharded (B,) array — mean/max/p50.

    The only cross-device communication in the system: an all-reduce
    materialized by XLA from these reductions.
    """
    sharding = batch_sharding(mesh)

    @jax.jit
    def f(v):
        v = jax.lax.with_sharding_constraint(v, sharding)
        return {
            "mean": jnp.mean(v),
            "max": jnp.max(v),
            "p50": jnp.median(v),
        }

    return f(values)
