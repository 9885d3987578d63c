"""Synthetic batched-function-evaluation sweep (CusADi's general role).

The reference's CusADi is a *general* tool: any CasADi function tape ->
one-thread-per-env CUDA kernel, benchmarked on synthetic functions of
1e1..1e5 instructions over batch 1..32768
(`/root/reference/biped_pympc/cusadi/run_benchmarks.py:10-96`, fns named
`fn_1e1`..`fn_1e5`). The JAX answer to that role is JAX itself: an
arbitrary elementwise instruction tape is a jitted pure function, XLA
fuses it, and the batch is one array axis. This harness measures that
claim with the same experiment design:

  methods
    xla     - jitted batch-last evaluation of the tape (the CusADi-kernel
              analog: one fused device program)
    cpu     - NumPy f64 serial evaluation (the reference's serial-CPU
              baseline, `evaluate_serial_cpu.cpp` role)

  workload: a deterministic pseudo-random straight-line tape of N_OPS
  scalar SSA instructions over a 16-wide state (mix of fma / mul / add /
  tanh-free rational ops — the CasADi op classes that dominate the
  reference's MPC tapes), evaluated per env.

Prints one JSON line per (method, n_ops, batch): ms/eval and
instruction-throughput (ops * batch / s), with the device it ran on.
Chained-scan timing as bench.py.

Usage: python bench_synthetic.py [--ops 1e1,1e2,1e3,1e4,1e5]
                                 [--batches 256,4096,32768] [--cpu]
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]


import argparse
import json
import time

import numpy as np

N_STATE = 16


def make_tape(n_ops: int, seed: int = 0):
    """Deterministic SSA tape: list of (op, dst, a, b, const)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        op = rng.choice(("fma", "mul", "add", "sub", "div1p"))
        dst = int(rng.integers(0, N_STATE))
        a = int(rng.integers(0, N_STATE))
        b = int(rng.integers(0, N_STATE))
        c = float(rng.uniform(-0.01, 0.01))
        ops.append((op, dst, a, b, c))
    return ops


def apply_tape_rows(tape, s):
    """Evaluate the tape on a (N_STATE, ...) array of state ROWS.

    Keepdims row indexing only, so every op stays a full-batch row op."""
    import jax.numpy as jnp

    rows = [s[i : i + 1] for i in range(N_STATE)]
    for op, dst, a, b, c in tape:
        x, y = rows[a], rows[b]
        if op == "fma":
            r = x * y + c
        elif op == "mul":
            r = x * y
        elif op == "add":
            r = x + y
        elif op == "sub":
            r = x - y
        else:  # div1p: rational op, bounded denominator
            r = x / (1.0 + y * y)
        rows[dst] = 0.5 * rows[dst] + 0.5 * r  # keep magnitudes bounded
    return jnp.concatenate(rows, axis=0)


def eval_cpu(tape, state):  # (B, N_STATE) f64 serial NumPy
    out = state.copy()
    for env in range(state.shape[0]):
        s = list(out[env])
        for op, dst, a, b, c in tape:
            x, y = s[a], s[b]
            if op == "fma":
                r = x * y + c
            elif op == "mul":
                r = x * y
            elif op == "add":
                r = x + y
            elif op == "sub":
                r = x - y
            else:
                r = x / (1.0 + y * y)
            s[dst] = 0.5 * s[dst] + 0.5 * r
        out[env] = s
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ops", default="1e1,1e2,1e3,1e4,1e5")
    p.add_argument("--batches", default="256,4096,32768")
    p.add_argument("--chain", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true",
                   help="also run the serial NumPy baseline (slow)")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from bench_common import device_info
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = device_info()

    def timed(fn, x, chain, reps):
        @jax.jit
        def chained(x):
            def body(s, _):
                return fn(s), ()
            out, _ = jax.lax.scan(body, x, None, length=chain)
            return out

        t0 = time.perf_counter()
        np.asarray(chained(x))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(chained(x))
            ts.append((time.perf_counter() - t0) / chain)
        return float(np.median(ts)), compile_s

    for n_ops_s in args.ops.split(","):
        n_ops = int(float(n_ops_s))
        tape = make_tape(n_ops)

        def xla_fn(s):  # s: (N_STATE, B) batch-last
            return apply_tape_rows(tape, s)

        for batch in [int(b) for b in args.batches.split(",")]:
            rng = np.random.default_rng(1)
            x = jnp.asarray(
                rng.uniform(0.5, 1.5, (N_STATE, batch)).astype(np.float32))
            t, compile_s = timed(xla_fn, x, args.chain, args.reps)
            print(json.dumps({
                "method": "xla", "n_ops": n_ops, "batch": batch,
                "ms_per_eval": 1e3 * t,
                "giga_instr_per_sec": n_ops * batch / t / 1e9,
                "compile_s": compile_s, "device": dev,
            }), flush=True)
            if args.cpu and n_ops * batch <= 10_000_000:
                xs = np.asarray(x.T, dtype=np.float64)
                t0 = time.perf_counter()
                eval_cpu(tape, xs)
                t = time.perf_counter() - t0
                print(json.dumps({
                    "method": "cpu_serial", "n_ops": n_ops, "batch": batch,
                    "ms_per_eval": round(1e3 * t, 2),
                    "giga_instr_per_sec": round(n_ops * batch / t / 1e9, 4),
                }), flush=True)


if __name__ == "__main__":
    main()
