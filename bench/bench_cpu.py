"""CPU baseline benchmark: native C++ (serial / OpenMP) vs JAX-CPU solver.

The role of the reference's `evaluate_serial_cpu.cpp` / `evaluate_parallel_cpu.cpp`
harness (`/root/reference/biped_pympc/cusadi/src/benchmark_functions/`):
measure per-env SRBD-MPC solve throughput on CPU to anchor the GPU speedup
numbers reported by bench.py. Prints one JSON line per method.
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]


import json
import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from biped_pympc_tpu import native
    from biped_pympc_tpu.models.srbd import SrbdLin
    from biped_pympc_tpu.ops import pdipm, qp as qps

    B = 64
    T = 10
    iters = 20
    rng = np.random.default_rng(0)

    rot = np.tile(np.eye(3), (B, 1, 1))
    i_world = np.tile(np.diag([0.5413, 0.52, 0.0691]), (B, 1, 1))
    body_pos = np.tile([0.0, 0.0, 0.55], (B, 1))
    foot_pos = np.tile([[0.05, 0.08, 0.0], [0.05, -0.08, 0.0]], (B, 1, 1))
    q_w = np.array([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1])
    r_w = np.full(12, 1e-5)
    r_w[6:] = 1e-4
    x0 = rng.uniform(-0.05, 0.05, (B, 12))
    x0[:, 5] += 0.55
    x_ref = np.zeros((B, T, 12))
    x_ref[:, :, 5] = 0.55
    x_ref[:, :, 9] = rng.uniform(-0.3, 0.3, B)[:, None]
    contact = np.ones((B, T, 2))

    kw = dict(dt_mpc=0.025, mu=1.0, mass=13.856, iterations=iters)

    def timed(fn, reps=5):
        fn()  # warmup
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    results = {}
    t = timed(lambda: native.solve_batch(
        x0, x_ref, contact, rot, i_world, body_pos, foot_pos, q_w, r_w,
        n_threads=0, **kw))
    results["cpu_serial_cpp"] = B / t

    t = timed(lambda: native.solve_batch(
        x0, x_ref, contact, rot, i_world, body_pos, foot_pos, q_w, r_w,
        n_threads=-1, **kw))
    results["cpu_openmp_cpp"] = B / t

    # JAX CPU path (f32, tridiag_aug default)
    def make_qp(i):
        lin = SrbdLin(
            rot_body=jnp.asarray(rot[i], jnp.float32),
            inertia_world=jnp.asarray(i_world[i], jnp.float32),
            body_pos=jnp.asarray(body_pos[i], jnp.float32),
            foot_pos=jnp.asarray(foot_pos[i], jnp.float32),
            mass=jnp.asarray(13.856, jnp.float32),
            residual_lin_accel=jnp.zeros(3, jnp.float32),
            residual_ang_accel=jnp.zeros(3, jnp.float32),
        )
        return qps.build_qp(
            lin, jnp.asarray(x0[i], jnp.float32),
            jnp.asarray(x_ref[i], jnp.float32),
            jnp.asarray(contact[i], jnp.float32), jnp.asarray(0.025, jnp.float32),
            jnp.asarray(1.0, jnp.float32), jnp.asarray(q_w, jnp.float32),
            jnp.asarray(r_w, jnp.float32), T,
        )

    batch_qp = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[make_qp(i) for i in range(B)]
    )
    opts = pdipm.PdipmOptions(
        backend="tridiag_aug", refine_steps=1, iterations=iters
    )
    solve = jax.jit(jax.vmap(lambda q: pdipm.solve(q, opts).x))
    t = timed(lambda: jax.block_until_ready(solve(batch_qp)))
    results["cpu_jax_f32"] = B / t

    from bench_common import make_emitter

    emit = make_emitter("bench_cpu")
    for name, rate in results.items():
        emit({
            "metric": f"{name}_solves_per_sec_b{B}_h10_20iter",
            "value": round(rate, 2),
            "unit": "solves/s",
        })


if __name__ == "__main__":
    main()
