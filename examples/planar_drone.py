"""Massively-batched planar-drone LQR sweeps and region-of-attraction.

JAX re-expression of the reference CusADi examples
(`/root/reference/biped_pympc/cusadi/examples/planar_drone_LQR.py:1-106` and
`planar_drone_ROA.py:1-62`): thousands of closed-loop simulations in
parallel, sweeping controller weights (Q, R), model parameters (mass) and
actuator limits (F_lim) across the environment batch. The reference runs a
prebuilt `.casadi` graph through the CusADi CUDA runtime with a Python loop
per control step (1 kernel launch / ms of sim time); here the whole rollout
is ONE `lax.scan` inside jit — no artifacts, no per-step dispatch — and the
per-env LQR gain is a batched fixed-point DARE solve under `vmap`.

Physics (standard planar bi-rotor; the reference's drone model ships only as
a Google-Drive artifact, so constants are chosen, not copied):
  state [x, y, th, xd, yd, thd], inputs [F1, F2] (rotor thrusts, arm L):
    m xdd = -(F1 + F2) sin th
    m ydd =  (F1 + F2) cos th - m g
    I thdd = L (F1 - F2)
  hover: F1 = F2 = m g / 2. LQR is designed about hover and applied to the
  nonlinear model with thrust saturation [0, F_lim] (`planar_drone_ROA`'s
  success criterion: ||state(T)|| < 1e-3).

Run: python examples/planar_drone.py [--quick]
"""

from __future__ import annotations

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np

G = 9.81
ARM = 0.25  # rotor arm length [m]
DT = 0.001  # control/sim step, matches the reference's dt (`:20`)


def _inertia(mass):
    return 0.5 * mass * ARM**2


def hover_linearization(mass: np.ndarray):
    """Batched (Ad, Bd) of the planar bi-rotor linearized about hover,
    forward-Euler discretized at DT. numpy float64 — the gain computation
    is setup-time host work (the f32 fixed point loses the slow modes:
    Ad = I + 1e-3 A contracts at ~1e-3/step, drowning in f32 roundoff
    over the ~2e4 iterations it needs)."""
    mass = np.atleast_1d(np.asarray(mass, np.float64))
    n = mass.shape[0]
    inertia = np.asarray(_inertia(mass))
    a = np.zeros((n, 6, 6))
    a[:, 0, 3] = a[:, 1, 4] = a[:, 2, 5] = 1.0
    a[:, 3, 2] = -G  # d(xdd)/d(th) at hover: -(F1+F2)/m = -g
    b = np.zeros((n, 6, 2))
    b[:, 4, 0] = b[:, 4, 1] = 1.0 / mass
    b[:, 5, 0] = ARM / inertia
    b[:, 5, 1] = -ARM / inertia
    return np.eye(6)[None] + DT * a, DT * b


def dare_gain(q_diag, r_diag, mass, iterations: int = 20000):
    """Per-env discrete LQR gains via batched fixed-point Riccati iteration
    in host float64 (one-time setup). Accepts (6,)/(2,)/scalar for a single
    env or (B, 6)/(B, 2)/(B,) batches; returns (2, 6) or (B, 2, 6) f32."""
    q_diag = np.atleast_2d(np.asarray(q_diag, np.float64))
    r_diag = np.atleast_2d(np.asarray(r_diag, np.float64))
    single = np.ndim(mass) == 0 and q_diag.shape[0] == 1
    ad, bd = hover_linearization(mass)
    n = ad.shape[0]
    q = np.zeros((n, 6, 6))
    q[:, np.arange(6), np.arange(6)] = q_diag
    r = np.zeros((n, 2, 2))
    r[:, np.arange(2), np.arange(2)] = r_diag

    adT = np.swapaxes(ad, 1, 2)
    bdT = np.swapaxes(bd, 1, 2)
    p = q.copy()
    for _ in range(iterations):
        btp = bdT @ p
        k = np.linalg.solve(r + btp @ bd, btp @ ad)
        acl = ad - bd @ k
        p = q + np.swapaxes(k, 1, 2) @ r @ k + np.swapaxes(acl, 1, 2) @ p @ acl
    btp = bdT @ p
    k = np.linalg.solve(r + btp @ bd, btp @ ad)  # (n, 2, 6)
    k32 = jnp.asarray(k, jnp.float32)
    return k32[0] if single else k32


def drone_step(state, gain, f_lim, mass):
    """One closed-loop nonlinear step with thrust saturation (per env)."""
    hover = 0.5 * mass * G
    u = hover - gain @ state  # LQR about hover
    u = jnp.clip(u, 0.0, f_lim)
    x, y, th, xd, yd, thd = state
    thrust = u[0] + u[1]
    xdd = -thrust * jnp.sin(th) / mass
    ydd = thrust * jnp.cos(th) / mass - G
    thdd = ARM * (u[0] - u[1]) / _inertia(mass)
    # Semi-implicit Euler (velocity first) for long-horizon stability.
    xd, yd, thd = xd + DT * xdd, yd + DT * ydd, thd + DT * thdd
    return jnp.stack(
        [x + DT * xd, y + DT * yd, th + DT * thd, xd, yd, thd]
    )


@functools.partial(jax.jit, static_argnums=(4,))
def rollout(state0, gains, f_lim, mass, n_steps: int):
    """Batched closed-loop rollout; returns final states and a coarse
    trajectory subsample (every 100 steps) for plotting."""
    step = jax.vmap(drone_step)

    def body(carry, _):
        s = step(carry, gains, f_lim, mass)
        return s, ()

    def outer(carry, _):
        s, _ = jax.lax.scan(body, carry, None, length=100)
        return s, s[:, :3]

    final, coarse = jax.lax.scan(outer, state0, None, length=n_steps // 100)
    return final, coarse


def lqr_sweeps(n_per_init: int = 50, t_end: float = 15.0):
    """The reference's three sweeps (`planar_drone_LQR.py:52-99`): Q_x,
    mass, R_1 over logspace, each from 3 initial displacements."""
    n_envs = 3 * n_per_init
    inits = jnp.concatenate([
        jnp.tile(jnp.array([-2.0, -2.0, 0, 0, 0, 0]), (n_per_init, 1)),
        jnp.tile(jnp.array([1.0, -1.0, 0, 0, 0, 0]), (n_per_init, 1)),
        jnp.tile(jnp.array([-1.0, 2.0, 0, 0, 0, 0]), (n_per_init, 1)),
    ])
    q_def = jnp.ones((n_envs, 6))
    r_def = jnp.ones((n_envs, 2))
    mass_def = jnp.ones(n_envs)
    f_lim = jnp.full((n_envs, 2), 50.0)
    n_steps = int(t_end / DT)

    sweeps = {}
    logspace = jnp.tile(
        jnp.logspace(np.log10(0.05), np.log10(20.0), n_per_init), 3
    )
    cases = {
        "baseline": (q_def, r_def, mass_def),
        "Q_x": (q_def.at[:, 0].set(logspace), r_def, mass_def),
        "R_1": (q_def, r_def.at[:, 0].set(
            jnp.tile(jnp.logspace(-2, 2, n_per_init), 3)), mass_def),
        "mass": (q_def, r_def, jnp.tile(
            jnp.logspace(np.log10(0.25), np.log10(4.0), n_per_init), 3)),
    }
    for name, (q, r, m) in cases.items():
        gains = dare_gain(q, r, m)
        final, coarse = rollout(inits, gains, f_lim, m, n_steps)
        err = jnp.linalg.norm(final, axis=1)
        sweeps[name] = {
            "final_err_median": float(jnp.median(err)),
            "settled_frac": float(jnp.mean(err < 1e-2)),
            "coarse_traj_shape": tuple(coarse.shape),
        }
    return sweeps


def region_of_attraction(n_envs: int = 30000, t_end: float = 10.0, seed: int = 0):
    """ROA sweep over F_lim (`planar_drone_ROA.py:29-62`): random initial
    linear/angular momentum, success = ||state(T)|| < 1e-3."""
    rng = np.random.default_rng(seed)
    v_max, omega_max = 20.0, 5.0
    omg = omega_max * (2 * rng.random(n_envs) - 1)
    ang = np.pi * (2 * rng.random(n_envs) - 1)
    mag = v_max * (2 * rng.random(n_envs) - 1)
    state0 = jnp.asarray(np.stack([
        np.zeros(n_envs), np.zeros(n_envs), np.zeros(n_envs),
        mag * np.cos(ang), mag * np.sin(ang), omg,
    ], axis=1), dtype=jnp.float32)

    mass = jnp.ones(n_envs)
    # All ROA envs share one controller (the sweep is over F_lim / initial
    # momentum): one DARE solve, broadcast.
    gain = dare_gain(np.ones(6), np.ones(2), 1.0)
    gains = jnp.tile(gain[None], (n_envs, 1, 1))
    n_steps = int(t_end / DT)

    results = {}
    for f_lim_val in (10.0, 20.0, 30.0, 40.0, 50.0):
        f_lim = jnp.full((n_envs, 2), f_lim_val)
        final, _ = rollout(state0, gains, f_lim, mass, n_steps)
        success = jnp.linalg.norm(final, axis=1) < 1e-3
        results[f_lim_val] = float(jnp.mean(success))
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="small sizes for smoke testing")
    args = p.parse_args()

    if args.quick:
        sweeps = lqr_sweeps(n_per_init=4, t_end=2.0)
        roa = region_of_attraction(n_envs=256, t_end=2.0)
    else:
        sweeps = lqr_sweeps()
        roa = region_of_attraction()

    print("LQR sweeps (150 envs x 15 s unless --quick):")
    for name, stats in sweeps.items():
        print(f"  {name:9s}: median final err {stats['final_err_median']:.2e}, "
              f"settled {100 * stats['settled_frac']:.0f}%")
    print("Region of attraction, success fraction vs F_lim:")
    for f, frac in roa.items():
        print(f"  F_lim {f:5.1f} N: {100 * frac:5.1f}%")


if __name__ == "__main__":
    main()
