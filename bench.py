"""Benchmark: batched SRBD-MPC 5-iteration solve units/s on one device.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "solves/s", "vs_baseline": R, ...}

Metric definition (BASELINE.json): QP solves/s at batch 4096, horizon 10,
5 Newton iterations — one "solve" = the work of one launch of the
reference's fused 5-iteration PDIPM CUDA kernel
(`mpc_controller_cusadi.py:28,144`). The full MPC tick runs 20 iterations
(4 launches), so one timed 20-iteration run_mpc = 4 solves per env.

Timing: K MPC solves are chained inside a single jit via `lax.scan` (each
step's state feeds the next) and timed to a host transfer, so the clock
covers the device work of every solve.

vs_baseline is the rate over the real-time requirement of the target
deployment (the reference publishes no absolute numbers, `BASELINE.md`):
4096 envs x 100 Hz MPC x 4 launches = 1,638,400 5-iteration solves/s.

Usage: python bench.py [BATCH=4096] [CHAIN_LEN=20] [SOLVER] [--mesh]
The result names the device (platform, kind, count) and the card's name and
power limit; it is a device number only when the platform is "gpu".
"""

import os
import sys
import time

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench"))

import numpy as np


def main():
    if "--help" in sys.argv or "-h" in sys.argv:
        print(__doc__)
        return

    import jax
    import jax.numpy as jnp

    from bench_common import device_info, make_emitter
    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    use_mesh = "--mesh" in sys.argv
    argv = [a for a in sys.argv if a != "--mesh"]
    batch = int(argv[1]) if len(argv) > 1 else 4096
    chain_len = int(argv[2]) if len(argv) > 2 else 20
    solver = argv[3] if len(argv) > 3 else "auto"
    mpc_cfg = MPCConf(solver=solver, verbose=False)
    core = BipedControllerCore(ControllerConf(), mpc_cfg, gait_id=2)
    state = core.init_state(batch)

    # Domain-randomized walking workload.
    rng = np.random.default_rng(0)
    num_dof = core.num_dof
    obs = np.zeros((batch, 13 + 6 * num_dof), dtype=np.float32)
    obs[:, 2] = 0.55 + rng.uniform(-0.02, 0.02, batch)
    obs[:, 3] = 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], dtype=np.float32)
    obs[:, 13: 13 + num_dof] = q0 + rng.uniform(-0.05, 0.05, (batch, num_dof))
    obs[:, 13 + num_dof: 13 + 2 * num_dof] = q0
    state = core.set_command(
        state,
        jnp.asarray(rng.uniform(-0.3, 0.3, (batch, 3)).astype(np.float32)),
        jnp.full((batch,), 0.55, dtype=jnp.float32),
    )
    state = core.ingest_state(state, jnp.asarray(obs))
    state = state._replace(
        gait_phase=jnp.asarray(rng.uniform(0, 1, batch).astype(np.float32))
    )

    def chain_body(st):
        def body(s, _):
            s2, out = core.run_mpc(s)
            return s2, out.grf_world[:, 2].sum()
        _, outs = jax.lax.scan(body, st, None, length=chain_len)
        return outs

    n_dev = 1
    if use_mesh:
        # Shard the env batch over every local device (parallel/mesh.py):
        # per-env solves are independent, so the sharded step has no
        # inter-device communication. shard_map runs each device's solve on
        # its own shard (the route the fused solver needs, see
        # mesh.controller_step).
        from jax.sharding import PartitionSpec as P

        from biped_pympc_tpu.parallel import mesh as pmesh

        mesh = pmesh.make_mesh()
        n_dev = len(jax.devices())
        assert batch % n_dev == 0, f"batch {batch} % devices {n_dev} != 0"
        state = pmesh.shard_state(state, mesh)
        spec = P(pmesh.DATA_AXIS)
        chain = jax.jit(pmesh.shard_map_compat(chain_body, mesh, spec, spec))
    else:
        chain = jax.jit(chain_body)

    t0 = time.perf_counter()
    _ = np.asarray(chain(state))  # compile + first run
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = np.asarray(chain(state))
        times.append((time.perf_counter() - t0) / chain_len)
    p50 = float(np.median(times))  # seconds per one batched 20-iter solve

    units_per_run = mpc_cfg.newton_iterations / 5.0  # 5-iteration units
    solves_per_sec = batch * units_per_run / p50
    realtime_requirement = 4096 * 100 * 4

    tag = f"_x{n_dev}devices" if n_dev > 1 else ""
    result = {
        "metric": f"qp_solves_per_sec_b{batch}_h10_5iter{tag}",
        "value": solves_per_sec,
        "unit": "solves/s",
        "vs_baseline": solves_per_sec / realtime_requirement,
        "extra": {
            "p50_latency_ms_20iter_batch": 1e3 * p50,
            "batch": batch,
            "devices": n_dev,
            "newton_iterations": mpc_cfg.newton_iterations,
            "chain_len": chain_len,
            "compile_s": compile_s,
            "device": device_info(),
            "solver": core.solver,
        },
    }
    emit = make_emitter("bench", {"argv": sys.argv[1:]})
    emit(result)


if __name__ == "__main__":
    main()
