"""Robustness fuzz: extreme inputs through the public API must stay finite.

The controller ingests raw simulator state; RL training will feed it
arbitrary garbage mid-exploration (flying robots, folded legs, huge
velocities). No layer may emit NaN/Inf torques or crash.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from biped_pympc_tpu import ControllerConf, MPCConf, MPCController


def _random_qp(rng, horizon, contact_row, mu, f_max, dt,
               lt=0.07, lh=0.04):
    """One randomized walking-class QP with a prescribed contact table row
    pattern ('both', 'left', 'right', 'none', 'flip')."""
    from biped_pympc_tpu.models.srbd import SrbdLin
    from biped_pympc_tpu.ops import qp as qps

    T = horizon
    rpy = rng.uniform(-0.15, 0.15, 3)
    pos = np.array([0.0, 0.0, rng.uniform(0.4, 0.7)])
    x0 = np.concatenate([rpy, pos, rng.uniform(-0.5, 0.5, 6)])
    x_ref = np.zeros((T, 12))
    x_ref[:, 5] = pos[2]
    x_ref[:, 9] = rng.uniform(-0.5, 0.5)
    table = {
        "both": np.ones((T, 2)),
        "left": np.tile([1.0, 0.0], (T, 1)),
        "right": np.tile([0.0, 1.0], (T, 1)),
        "none": np.zeros((T, 2)),  # flight phase: all rows swing
        "flip": np.stack([np.arange(T) % 2, 1 - np.arange(T) % 2], axis=1),
    }[contact_row]
    foot = np.stack([pos + [0.02, 0.08, -pos[2]],
                     pos + [-0.02, -0.08, -pos[2]]])
    lin = SrbdLin(
        rot_body=jnp.eye(3, dtype=jnp.float64),
        inertia_world=jnp.asarray(np.diag([0.5413, 0.52, 0.0691])),
        body_pos=jnp.asarray(pos),
        foot_pos=jnp.asarray(foot),
        mass=jnp.asarray(13.856),
        residual_lin_accel=jnp.zeros(3, jnp.float64),
        residual_ang_accel=jnp.zeros(3, jnp.float64),
    )
    q_diag = jnp.asarray([150, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1],
                         jnp.float64)
    r_diag = jnp.asarray([1e-5] * 6 + [1e-4] * 6, jnp.float64)
    return qps.build_qp(
        lin, jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(table),
        jnp.asarray(dt), jnp.asarray(mu), q_diag, r_diag, T,
        "rt_omega", jnp.asarray(f_max), jnp.asarray(lt), jnp.asarray(lh),
    )


def test_degenerate_contacts_and_extreme_knobs_stay_finite():
    """Fast-tier fuzz: degenerate contact tables
    (all-stance, single-leg, full flight, per-stage flips) crossed with
    extreme per-env mu/f_max/dt_mpc draws, solved by the pure-JAX f64
    backend in ONE vmapped program — every solution finite, every
    stationarity residual small relative to problem scale."""
    from biped_pympc_tpu.ops import pdipm

    rng = np.random.default_rng(42)
    rows = ["both", "left", "right", "none", "flip"]
    qps_list = []
    for i in range(20):
        qps_list.append(_random_qp(
            rng, 10, rows[i % 5],
            mu=rng.uniform(0.05, 2.0),
            f_max=rng.uniform(50.0, 2000.0),
            dt=rng.uniform(0.005, 0.08),
            # round 5: contact lever arms are per-env data too
            lt=rng.uniform(0.02, 0.15),
            lh=rng.uniform(0.02, 0.12),
        ))
    qp = jax.tree.map(lambda *xs: jnp.stack(xs), *qps_list)

    opts = pdipm.PdipmOptions(backend="tridiag_aug")
    sol = jax.jit(jax.vmap(lambda q: pdipm.solve(q, opts)))(qp)
    for leaf in (sol.x, sol.s, sol.z, sol.y):
        assert np.isfinite(np.asarray(leaf)).all()
    # Flight-phase stages force fz <= 0: vertical forces must vanish there
    # (to IPM tolerance — the barrier leaves ~1e-6 N at 20 iterations).
    u0 = np.asarray(sol.x[:, 120:132])
    for i in range(3, 20, 5):  # the "none" rows
        np.testing.assert_allclose(u0[i].reshape(4, 3)[:2, 2], 0.0,
                                   atol=1e-4)
    res = np.asarray(sol.residuals)
    # Feasibility and complementarity converge tightly; absolute
    # stationarity scales with the (randomized, sometimes huge) cost
    # gradient, so it is not thresholded here.
    # 2e-3: round 5 randomizes the contact lever arms too, and the
    # widened draw space includes slightly slower-converging QPs
    # (worst observed 1.05e-3 at 20 iterations).
    assert (res[:, 1:3] < 2e-3).all(), f"poor feasibility: {res.max(axis=0)}"
    assert (res[:, 3] < 1e-2).all(), f"poor complementarity: {res.max(axis=0)}"


def test_extreme_horizons_stay_finite():
    """Horizon extremes (T=3 and T=25) through the same pure-JAX f64 path;
    the block-tridiagonal elimination has no T=10-specific constants."""
    from biped_pympc_tpu.ops import pdipm

    rng = np.random.default_rng(3)
    for horizon in (3, 25):
        qs = [_random_qp(rng, horizon, row, mu=0.7, f_max=500.0, dt=0.025)
              for row in ("both", "flip")]
        qp = jax.tree.map(lambda *xs: jnp.stack(xs), *qs)
        sol = jax.jit(jax.vmap(
            lambda q: pdipm.solve(q, pdipm.PdipmOptions(backend="tridiag_aug"))
        ))(qp)
        assert np.isfinite(np.asarray(sol.x)).all(), f"T={horizon}"
        res = np.asarray(sol.residuals)
        # Feasibility (rs, re) converges tightly at any horizon; the
        # absolute stationarity norm scales with the cost gradient (f
        # entries ~1e2), so only complementarity mu is bounded here.
        assert (res[:, 1:3] < 1e-4).all(), f"T={horizon}: {res}"
        assert (res[:, 3] < 1e-2).all(), f"T={horizon}: {res}"


@pytest.mark.slow
@pytest.mark.parametrize("robot,dof", [("HECTOR", 5), ("T1-newton", 6)])
def test_extreme_states_stay_finite(robot, dof):
    B = 8
    ctrl = MPCController(
        ControllerConf(), MPCConf(robot=robot), num_envs=B, gait_id=2
    )
    rng = np.random.default_rng(0)
    width = 13 + 6 * dof

    for trial in range(3):
        obs = np.zeros((B, width), dtype=np.float32)
        obs[:, 0:3] = rng.uniform(-5, 5, (B, 3))  # wild positions
        obs[:, 2] = rng.uniform(0.05, 2.0, B)  # heights incl. near-ground
        quat = rng.standard_normal((B, 4))
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)  # random attitude
        obs[:, 3:7] = quat
        obs[:, 7:13] = rng.uniform(-8, 8, (B, 6))  # large twists
        obs[:, 13: 13 + 2 * dof] = rng.uniform(-2.5, 2.5, (B, 2 * dof))
        obs[:, 13 + 2 * dof:] = rng.uniform(-3, 3, (B, 4 * dof))

        twist = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
        height = rng.uniform(0.2, 1.0, B).astype(np.float32)
        ctrl.set_command(twist, height)
        ctrl.update_state(obs)
        ctrl.run_mpc()
        ctrl.run_lowlevel()
        tau = np.asarray(ctrl.get_action())
        assert np.isfinite(tau).all(), f"non-finite torque, trial {trial}"
        wrench = np.asarray(ctrl.ground_reaction_wrench)
        assert np.isfinite(wrench).all(), f"non-finite wrench, trial {trial}"
        # torque limits always respected
        assert np.abs(tau).max() <= 67.0 + 1e-4

        # random mid-run resets keep everything consistent
        ctrl.reset(rng.integers(0, B, size=2))


@pytest.mark.slow
def test_per_env_heterogeneous_knobs_stay_finite():
    """Controller-level heterogeneity fuzz: every env
    draws its own extreme mu / f_max / dt_mpc / swing-shape / acceleration
    residual AND a random (12,12) matrix residual, in one batch, through
    the full public API — outputs finite, limits respected."""
    B = 8
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=B, gait_id=2)
    rng = np.random.default_rng(7)

    obs = np.zeros((B, 43), dtype=np.float32)
    obs[:, 2] = rng.uniform(0.35, 0.75, B)
    obs[:, 3] = 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], dtype=np.float32)
    obs[:, 13:18] = q0
    obs[:, 18:23] = q0

    ctrl.set_command(rng.uniform(-1, 1, (B, 3)).astype(np.float32),
                     rng.uniform(0.3, 0.8, B).astype(np.float32))
    ctrl.update_mpc_sampling_time(rng.uniform(0.005, 0.08, B).astype(np.float32))
    ctrl.set_swing_parameters(
        foot_height=rng.uniform(0.01, 0.25, B).astype(np.float32),
        cp1=rng.uniform(0.0, 1.0, B).astype(np.float32),
        cp2=rng.uniform(0.0, 1.0, B).astype(np.float32))
    ctrl.set_contact_parameters(
        mu=rng.uniform(0.05, 2.0, B).astype(np.float32),
        f_max=rng.uniform(50.0, 2000.0, B).astype(np.float32))
    ctrl.set_srbd_accel(
        rng.uniform(-3, 3, (B, 3)).astype(np.float32),
        rng.uniform(-3, 3, (B, 3)).astype(np.float32))
    ctrl.set_srbd_residual(
        (0.1 * rng.standard_normal((B, 12, 12))).astype(np.float32),
        (0.1 * rng.standard_normal((B, 12, 12))).astype(np.float32))

    for i in range(12):
        ctrl.update_state(obs)
        if i % 4 == 0:
            ctrl.run_mpc()
        ctrl.run_lowlevel()
        tau = np.asarray(ctrl.get_action())
        assert np.isfinite(tau).all(), f"non-finite torque at tick {i}"
        assert np.abs(tau).max() <= 33.5 + 1e-4
    assert np.isfinite(np.asarray(ctrl.ground_reaction_wrench)).all()
    assert np.isfinite(np.asarray(ctrl.mpc_cost)).all()
