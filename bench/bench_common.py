"""Shared helpers for the benchmark / measurement scripts.

One definition of the walking-class stress-QP batch so `bench_sweep.py`,
`ab_accuracy.py` and `chip_smoke.py` always measure the same problem set
(8 base variants with contact-chattering tables, tiled to the batch size),
and one record of the device every result was measured on.
"""

import os as _os
import sys as _sys

# Repo root (one level up from bench/) — for `import biped_pympc_tpu` when a
# harness is launched as `python bench/<harness>.py`, and as the anchor for
# the shared results/ directory.
_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _ROOT not in _sys.path:
    _sys.path.insert(0, _ROOT)

import numpy as np


def card_info() -> str | None:
    """`name, power.limit` of the first NVIDIA card as nvidia-smi reports
    them, or None where there is no nvidia-smi."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else None


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it, plus the
    card's name and power limit (a capped card runs slower under load)."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def make_converged_qp(dtype=None, seed: int = 0, contact=None,
                      vx: float = 0.3, horizon: int = 10):
    """One HECTOR double-support walking QP (single env) that 20 Newton
    iterations solve to convergence — the solver tests' reference problem
    (`tests/test_pdipm.py`)."""
    import jax.numpy as jnp

    from biped_pympc_tpu.models.srbd import SrbdLin
    from biped_pympc_tpu.ops import qp as qps

    dtype = dtype or jnp.float64
    T = horizon
    lin = SrbdLin(
        rot_body=jnp.eye(3, dtype=dtype),
        inertia_world=jnp.asarray(np.diag([0.5413, 0.52, 0.0691]), dtype=dtype),
        body_pos=jnp.asarray([0.0, 0.0, 0.55], dtype=dtype),
        foot_pos=jnp.asarray([[0.05, 0.08, 0.0], [0.05, -0.08, 0.0]],
                             dtype=dtype),
        mass=jnp.asarray(13.856, dtype=dtype),
        residual_lin_accel=jnp.zeros(3, dtype=dtype),
        residual_ang_accel=jnp.zeros(3, dtype=dtype),
    )
    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(rng.uniform(-0.05, 0.05, 12), dtype=dtype)
    x0 = x0.at[5].add(0.5)
    x_ref = jnp.zeros((T, 12), dtype=dtype).at[:, 5].set(0.55).at[:, 9].set(vx)
    if contact is None:
        contact = jnp.ones((T, 2), dtype=dtype)
    q = jnp.asarray([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1],
                    dtype=dtype)
    r = jnp.full(12, 1e-5, dtype=dtype).at[6:].set(1e-4)
    return qps.build_qp(
        lin, x0, x_ref, jnp.asarray(contact, dtype=dtype),
        jnp.asarray(0.025, dtype=dtype), jnp.asarray(1.0, dtype=dtype), q, r, T
    )


def make_qp_batch(batch: int, horizon: int = 10):
    """(StageQP with leading batch axis) walking-class stress QPs."""
    import jax
    import jax.numpy as jnp

    from biped_pympc_tpu.models.srbd import SrbdLin
    from biped_pympc_tpu.ops import qp as qps

    rng = np.random.default_rng(0)
    qs = []
    for s in range(8):
        x0 = jnp.asarray(
            np.concatenate([
                rng.uniform(-0.05, 0.05, 3), [0, 0, 0.55],
                rng.uniform(-0.1, 0.1, 3), [0.05 * s, 0, 0],
            ]).astype(np.float32))
        x_ref = jnp.tile(
            jnp.asarray([0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0],
                        jnp.float32), (horizon, 1))
        contact = jnp.asarray(
            (np.arange(horizon * 2).reshape(horizon, 2) + s) % 2,
            jnp.float32)
        lin = SrbdLin(
            rot_body=jnp.eye(3, dtype=jnp.float32),
            inertia_world=jnp.asarray(
                np.diag([0.5413, 0.52, 0.0691]), jnp.float32),
            body_pos=x0[3:6],
            foot_pos=x0[3:6] + jnp.asarray(
                [[0.02, 0.06, -0.55], [0.02, -0.06, -0.55]], jnp.float32),
            mass=jnp.float32(13.856),
            residual_lin_accel=jnp.zeros(3, jnp.float32),
            residual_ang_accel=jnp.zeros(3, jnp.float32),
        )
        qs.append(qps.build_qp(
            lin, x0, x_ref, contact, jnp.float32(0.025), jnp.float32(1.0),
            jnp.asarray([150, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1],
                        jnp.float32),
            jnp.asarray([1e-5] * 6 + [1e-4] * 6, jnp.float32),
            horizon,
        ))
    one = jax.tree.map(lambda *xs: jnp.stack(xs), *qs)
    rep = max(1, batch // 8)
    full = jax.tree.map(
        lambda a: jnp.tile(a, (rep,) + (1,) * (a.ndim - 1)), one)
    return jax.tree.map(lambda a: a[:batch], full)


def make_qp_batch_randomized(batch: int, horizon: int = 10, seed: int = 0):
    """Fully domain-randomized walking-class QP batch (BASELINE config 5).

    Unlike `make_qp_batch` (8 stress variants tiled), EVERY env draws its
    own contact parameters — per-env friction mu in [0.4, 1.0] and force cap
    f_max in [300, 600] N (the knobs the reference bakes into its compiled
    kernel, `srbd_constraints.py:31,144-227`), plus randomized initial state,
    velocity command, gait phase offset, and foot positions. Exercises the
    per-env-heterogeneity claim at scale: one jitted solve, no recompiles.
    """
    import jax
    import jax.numpy as jnp

    from biped_pympc_tpu.models.srbd import SrbdLin
    from biped_pympc_tpu.ops import qp as qps

    rng = np.random.default_rng(seed)
    B, T = batch, horizon
    f32 = np.float32

    rpy = rng.uniform(-0.08, 0.08, (B, 3))
    pos = np.concatenate([rng.uniform(-0.02, 0.02, (B, 2)),
                          rng.uniform(0.5, 0.6, (B, 1))], axis=1)
    omega = rng.uniform(-0.2, 0.2, (B, 3))
    vel = rng.uniform(-0.15, 0.15, (B, 3))
    x0 = np.concatenate([rpy, pos, omega, vel], axis=1).astype(f32)

    vx_cmd = rng.uniform(-0.3, 0.5, (B, 1))
    vy_cmd = rng.uniform(-0.15, 0.15, (B, 1))
    x_ref = np.zeros((B, T, 12), f32)
    x_ref[:, :, 5] = 0.55
    x_ref[:, :, 9] = vx_cmd
    x_ref[:, :, 10] = vy_cmd

    # Per-env phase-offset alternating contact with occasional double support.
    phase = rng.integers(0, 2, (B, 1))
    steps = (np.arange(T)[None, :] + phase) % 2
    contact = np.stack([steps, 1 - steps], axis=2).astype(f32)
    dsp = rng.random((B, T)) < 0.15
    contact = np.where(dsp[:, :, None], 1.0, contact).astype(f32)

    foot = np.stack([
        pos + rng.uniform(-0.04, 0.08, (B, 3)) * [1, 1, 0] + [0, 0.06, 0],
        pos + rng.uniform(-0.04, 0.08, (B, 3)) * [1, 1, 0] + [0, -0.06, 0],
    ], axis=1).astype(f32)
    foot[:, :, 2] = 0.0
    foot_b = foot - pos[:, None, :].astype(f32)

    mu = rng.uniform(0.4, 1.0, (B,)).astype(f32)
    f_max = rng.uniform(300.0, 600.0, (B,)).astype(f32)

    q_diag = jnp.asarray([150, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1],
                         jnp.float32)
    r_diag = jnp.asarray([1e-5] * 6 + [1e-4] * 6, jnp.float32)

    def build_one(x0_i, xref_i, contact_i, foot_b_i, mu_i, fmax_i):
        lin = SrbdLin(
            rot_body=jnp.eye(3, dtype=jnp.float32),
            inertia_world=jnp.asarray(
                np.diag([0.5413, 0.52, 0.0691]), jnp.float32),
            body_pos=x0_i[3:6],
            foot_pos=x0_i[3:6] + foot_b_i,
            mass=jnp.float32(13.856),
            residual_lin_accel=jnp.zeros(3, jnp.float32),
            residual_ang_accel=jnp.zeros(3, jnp.float32),
        )
        return qps.build_qp(lin, x0_i, xref_i, contact_i, jnp.float32(0.025),
                            mu_i, q_diag, r_diag, horizon, f_max=fmax_i)

    return jax.jit(jax.vmap(build_one))(
        jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(contact),
        jnp.asarray(foot_b), jnp.asarray(mu), jnp.asarray(f_max))


def make_chained(solve_fn, chain):
    """Chained-scan device-timing harness shared by the benchmarks.

    Chains `chain` dependent solves inside one jit (each step's x feeds a
    1e-12 perturbation of the next problem's f) so the measured wall time
    is real sequential device compute, not pipelined same-input dispatch.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(q):
        def body(carry, _):
            qq = q._replace(f=q.f + 1e-12 * carry)
            res = solve_fn(qq)
            return res.x, ()
        out, _ = jax.lax.scan(body, jnp.zeros_like(q.f), None, length=chain)
        return out[:, 0].sum()
    return chained


def make_emitter(harness: str, params: dict | None = None,
                 results_dir: str | None = None):
    """JSON-line sink for measurement harnesses: prints each record AND
    appends it to `results/<harness>.jsonl`.

    This is the reference's offline sweep-export role
    (`cusadi/run_benchmarks.py:91-96` saves `.mat` for the MATLAB plots) in
    a diffable, machine-readable form: each run appends one `{"run": ...}`
    header (UTC timestamp + harness parameters + device) followed by its
    records, so runs diff without parsing prose.
    """
    import json
    import os
    import time

    d = results_dir or os.path.join(_ROOT, "results")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{harness}.jsonl")
    header = {
        "run": harness,
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "params": dict(params or {}),
        "device": device_info(),
    }
    # The file is opened and the run header written LAZILY on the first emit,
    # so a harness that crashes before producing any measurement leaves no
    # header-only stanza in the artifact; emit.close() releases the handle.
    state = {"f": None}

    def emit(obj: dict) -> None:
        line = json.dumps(obj)
        if state["f"] is None:
            print(json.dumps(header), flush=True)
            state["f"] = open(path, "a")
            state["f"].write(json.dumps(header) + "\n")
        print(line, flush=True)
        state["f"].write(line + "\n")
        state["f"].flush()

    def close() -> None:
        if state["f"] is not None:
            state["f"].close()
            state["f"] = None

    emit.close = close
    return emit
