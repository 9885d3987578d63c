"""f32 GRF accuracy of the solver ends against the f64 golden rule solver.

Three problem sets, each compared on u0 (the GRFs the controller applies)
with `ops/reference_pdipm.py` at 20 iterations:
  * the converged reference problem of the solver tests
    (`bench_common.make_converged_qp`; bound 0.05 N);
  * the 8 contact-chattering stress problems (`bench_common.make_qp_batch`;
    target <= 1 N);
  * the first envs of a domain-randomized batch
    (`bench_common.make_qp_batch_randomized`);
the envs of the whole randomized batch on which the two f32 solver ends
disagree most, against the golden at 20 iterations and at convergence
(`worst_disagreement`); and the float64 plain solver against the golden on
every field of the converged problem (median < 3e-7, max < 1e-5).
`chip_smoke.py` and the `gpu` tests call these functions; run alone it
prints one JSON line per solver and set:

    python bench/ab_accuracy.py [RANDOMIZED_BATCH=4096]
"""
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]

import json

import numpy as np

from bench_common import (device_info, make_converged_qp, make_qp_batch,
                          make_qp_batch_randomized)

CONVERGED_BOUND_N = 0.05
STRESS_TARGET_N = 1.0
F64_MEDIAN_BOUND = 3e-7
F64_MAX_BOUND = 1e-5


def _golden_run(qp_host, iterations: int):
    """(x, s, z, y, residuals) of the f64 golden solver for one env's host
    QP; residuals = [||rx||, ||rs||, ||re||, mu] of the last iteration."""
    import jax

    from biped_pympc_tpu.ops import qp as qps, reference_pdipm

    with jax.enable_x64(True):
        H, f, A, b, G, d = [np.asarray(m, np.float64)
                            for m in qps.dense_matrices(qp_host)]
    return reference_pdipm.solve(
        H, f, A, b, G, d,
        *reference_pdipm.initialize_variables(G, d, A.shape[0]),
        iterations=iterations,
    )


def golden(qp_host, iterations: int = 20):
    """(x, s, z, y) of the f64 golden solver for one env's host QP."""
    return _golden_run(qp_host, iterations)[:4]


def golden_u0(qp_batch, n: int, iterations: int = 20,
              with_residuals: bool = False):
    """(n, 12) golden u0 of the first n envs of a batched QP (and, with
    `with_residuals`, the (n, 4) golden residuals)."""
    import jax

    host = jax.tree.map(np.asarray, qp_batch)
    T = host.d.shape[1]
    out, res = np.empty((n, 12)), np.empty((n, 4))
    for i in range(n):
        gx, _, _, _, res[i] = _golden_run(
            jax.tree.map(lambda a: a[i], host), iterations)
        out[i] = gx[12 * T: 12 * T + 12]
    return (out, res) if with_residuals else out


def grf_error_stats(u0, gold) -> dict:
    """Per-env max |u0 - golden| [N]: max, p99, median, non-finite count."""
    u0 = np.asarray(u0, np.float64)
    nonfinite = int((~np.isfinite(u0)).any(axis=1).sum())
    e = np.abs(u0 - gold).max(axis=1)
    return {"max_N": float(np.nanmax(e)),
            "p99_N": float(np.nanpercentile(e, 99)),
            "median_N": float(np.nanmedian(e)), "nonfinite_envs": nonfinite}


def solver_fns(names, iterations: int = 20):
    """name -> jitted batched f32 solve (StageQP batch -> PdipmResult), for
    the plain ("ric_aug") and fused ("fused_ric_aug") solver ends, with
    matmuls at full precision."""
    import jax

    from biped_pympc_tpu.ops import pdipm, pdipm_fused

    opts = pdipm.PdipmOptions(iterations=iterations, backend="ric_aug",
                              foot_split=True, refine_steps=1)
    table = {
        "ric_aug": lambda q: jax.vmap(lambda e: pdipm.solve(e, opts))(q),
        "fused_ric_aug": lambda q: pdipm_fused.solve(q, opts),
    }

    def full_precision(fn):
        def run(q):
            with jax.default_matmul_precision("highest"):
                return fn(q)
        return jax.jit(run)

    return {n: full_precision(table[n]) for n in names}


def f32_accuracy(names, randomized_batch: int = 4096,
                 randomized_envs: int = 32) -> list[dict]:
    """One record per (solver, problem set); see the module docstring."""
    import jax
    import jax.numpy as jnp

    conv = jax.tree.map(lambda a: a[None], make_converged_qp(jnp.float32))
    stress = make_qp_batch(8)
    rand = make_qp_batch_randomized(randomized_batch)
    host64 = jax.tree.map(lambda a: np.asarray(a[0], np.float64), conv)
    T = conv.d.shape[1]
    gold = {
        "converged": golden(host64)[0][None, 12 * T: 12 * T + 12],
        "stress8": golden_u0(stress, 8),
        f"randomized{randomized_envs}_of_b{randomized_batch}":
            golden_u0(rand, randomized_envs),
    }
    sets = dict(zip(gold, (conv, stress, rand)))
    records = []
    for name, fn in solver_fns(names).items():
        for label, qp in sets.items():
            x = np.asarray(fn(qp).x)
            n = gold[label].shape[0]
            u0 = x[:n, 12 * T: 12 * T + 12]
            records.append({"solver": name, "set": label,
                            **grf_error_stats(u0, gold[label])})
    return records


def worst_disagreement(batch: int = 4096, k: int = 16,
                       converged_iterations: int = 60) -> dict:
    """Both f32 solver ends on the whole randomized batch, compared env for
    env; the k envs where they disagree most go to the golden.

    Reports the disagreement over the batch, and on those k envs each
    solver's u0 error against the golden at 20 iterations (what both
    implement) and at `converged_iterations` (the QP's optimum), the
    golden's own distance from the optimum and its stationarity residual
    at 20 iterations, and how far each solver moves when the k envs are
    solved as a batch of their own (the envs are independent, so any move
    is rounding).
    """
    import jax

    rand = make_qp_batch_randomized(batch)
    T = rand.d.shape[1]
    names = ("ric_aug", "fused_ric_aug")
    fns = solver_fns(names)
    u0 = lambda res: np.asarray(res.x)[:, 12 * T: 12 * T + 12]
    full = {n: u0(fn(rand)) for n, fn in fns.items()}
    d = np.abs(full["ric_aug"] - full["fused_ric_aug"]).max(axis=1)
    idx = np.argsort(-d)[:k]
    sub = jax.tree.map(lambda a: a[idx], rand)
    gold20, res20 = golden_u0(sub, k, with_residuals=True)
    gold_opt = golden_u0(sub, k, iterations=converged_iterations)

    def stats(e):
        return {"max_N": float(e.max()), "p99_N": float(np.percentile(e, 99)),
                "median_N": float(np.median(e))}

    err = lambda u, g: np.abs(u - g).max(axis=1)
    e20 = {n: err(full[n][idx], gold20) for n in names}
    solvers = {}
    for n, other in zip(names, names[::-1]):
        solvers[n] = {
            "vs_golden20": stats(e20[n]),
            "vs_optimum": stats(err(full[n][idx], gold_opt)),
            "closer_to_golden20_envs": int((e20[n] < e20[other]).sum()),
            "rebatched_move_N": float(err(u0(fns[n](sub)), full[n][idx]).max()),
            "nonfinite_envs": int((~np.isfinite(full[n])).any(axis=1).sum()),
        }
    return {
        "batch": batch, "k": k, "env_index": idx.tolist(),
        "disagreement": {**stats(d), "envs_over_1N": int((d > 1.0).sum())},
        "solvers": solvers,
        "golden20_vs_optimum": stats(err(gold20, gold_opt)),
        "golden20_stationarity": {"max": float(res20[:, 0].max()),
                                  "median": float(np.median(res20[:, 0]))},
        "converged_iterations": converged_iterations,
    }


def f64_plain_vs_golden() -> dict:
    """Plain ric_aug in float64 on the default device, every field of the
    converged problem against the golden: max and median abs error. x64 is
    on only inside this call."""
    import jax

    from biped_pympc_tpu.ops import pdipm

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        import jax.numpy as jnp

        qp = make_converged_qp(jnp.float64)
        gx, gs, gz, gy = golden(jax.tree.map(np.asarray, qp))
        opts = pdipm.PdipmOptions(backend="ric_aug", foot_split=True)
        res = jax.jit(lambda q: pdipm.solve(q, opts))(qp)
        if res.x.dtype != jnp.float64:
            raise RuntimeError(f"float64 solve ran in {res.x.dtype}")
        err = np.concatenate([
            np.abs(np.asarray(got) - want) for got, want in
            ((res.x, gx), (res.s, gs), (res.z, gz), (res.y, gy))])
    return {"solver": "ric_aug", "dtype": "float64",
            "max_abs": float(err.max()), "median_abs": float(np.median(err))}


def main():
    batch = int(_sys.argv[1]) if len(_sys.argv) > 1 else 4096
    dev = device_info()
    for rec in f32_accuracy(("ric_aug", "fused_ric_aug"), batch):
        print(json.dumps({**rec, "device": dev}), flush=True)
    print(json.dumps({**worst_disagreement(batch), "device": dev}),
          flush=True)
    print(json.dumps({**f64_plain_vs_golden(), "device": dev}), flush=True)


if __name__ == "__main__":
    main()
