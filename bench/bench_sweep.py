"""Batch-sweep benchmark: solves/s vs batch size for each solver method.

Role parity with the reference's benchmark harness
(`/root/reference/biped_pympc/cusadi/run_benchmarks.py:10-96`), which sweeps
batch 1..32768 over {cusadi kernel, torch.vmap, serial CPU, parallel CPU}.
Here the methods are the two f32 solver ends of the shipped algorithm
(foot-split "ric_aug", one refinement step):

  ric_aug        - pure-JAX vmapped solver, XLA-lowered (the torch.vmap
                   analog)
  fused_ric_aug  - the fused native kernel (`ops/pdipm_fused.py`; the
                   cusadi-kernel analog)

CPU serial / OpenMP baselines live in `bench_cpu.py` (C++,
`native/srbd_mpc_cpu.cpp`) — run that separately on a CPU host.

Prints one JSON line per (method, batch): ms per batched 20-iteration solve
and 5-iteration-solve-units/s (the headline unit, see bench.py), with the
device it ran on. Chained-scan timing amortizes the per-dispatch overhead.

Usage: python bench_sweep.py [--batches 64,256,1024,4096] [--chain 10]
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]


import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="64,256,1024,4096")
    p.add_argument("--methods", default="ric_aug,fused_ric_aug")
    p.add_argument("--chain", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--randomized", action="store_true",
                   help="BASELINE config 5 workload: per-env random mu/f_max/"
                        "contact tables/commands (make_qp_batch_randomized) "
                        "instead of the 8 tiled stress QPs")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from ab_accuracy import solver_fns
    from bench_common import (
        make_emitter, make_qp_batch, make_qp_batch_randomized,
    )
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    emit = make_emitter("bench_sweep", vars(args))

    def timed_chain(qp, solve_fn, chain, reps):
        @jax.jit
        def chained(q):
            def body(carry, _):
                qq = q._replace(f=q.f + 1e-12 * carry)
                res = solve_fn(qq)
                return res.x, ()
            out, _ = jax.lax.scan(body, jnp.zeros_like(q.f), None, length=chain)
            return out[:, 0].sum()

        t0 = time.perf_counter()
        np.asarray(chained(qp))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(chained(qp))
            ts.append((time.perf_counter() - t0) / chain)
        return float(np.median(ts)), compile_s

    methods = solver_fns(args.methods.split(","))

    for batch in [int(b) for b in args.batches.split(",")]:
        if args.randomized:
            qp = make_qp_batch_randomized(batch, horizon=args.horizon)
        else:
            qp = make_qp_batch(batch, horizon=args.horizon)
        for name, fn in methods.items():
            t, compile_s = timed_chain(qp, fn, args.chain, args.reps)
            extra = {}
            if args.randomized:
                # Solution-health stats for the domain-randomized run:
                # finite fraction + stance-force stats of u0.
                u0 = np.asarray(fn(qp).x[:, 120:132])
                finite = np.isfinite(u0).all(axis=1)
                fz = u0[:, [2, 5]]
                extra = {
                    "finite_frac": float(finite.mean()),
                    "fz_max_N": float(fz.max()),
                    "fz_p50_N": float(np.median(fz[fz > 1.0]))
                    if (fz > 1.0).any() else 0.0,
                }
            emit({
                **extra,
                "method": name, "batch": batch,
                "horizon": args.horizon,
                "workload": "randomized" if args.randomized else "stress8",
                "ms_per_solve": 1e3 * t,
                "solve_units_per_sec": batch * 4 / t,
                "compile_s": compile_s,
            })


if __name__ == "__main__":
    main()
