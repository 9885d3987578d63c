"""Profiling / tracing helpers.

The reference's observability is wall-clock prints gated by
`MPCConf.print_solve_time` plus cudaEvent kernel timings (SURVEY.md §5);
the equivalents here are:

  * `device_timer`: device time of a step — chained `lax.scan` execution
    ending in one host transfer, so the clock covers the device work and
    not only its enqueue.
  * `trace`: a thin wrapper over `jax.profiler.trace` producing a
    TensorBoard-loadable trace of the device execution.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np


def device_timer(step_fn: Callable, state, chain_len: int = 10, reps: int = 3):
    """Median seconds per call of `step_fn(state) -> state-like`.

    step_fn must return an updated state (or any pytree with the same
    structure as its input) so calls can be chained — chaining forces the
    device to actually execute every step sequentially.

    The sync point is a SINGLE SCALAR reduced inside the jit (every output
    leaf feeds it, so nothing is dead-code-eliminated). Transferring the
    full output pytree instead would time one host round-trip PER LEAF.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(st):
        def body(s, _):
            return step_fn(s), ()
        out, _ = jax.lax.scan(body, st, None, length=chain_len)
        leaves = [x for x in jax.tree.leaves(out)
                  if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)]
        return sum(jnp.sum(x) for x in leaves)

    np.asarray(chain(state))  # compile + sync

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(chain(state))
        times.append((time.perf_counter() - t0) / chain_len)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "trace")):
    """Profile a block: `with trace(): ctrl.run_mpc()` then inspect the
    trace in TensorBoard / xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
