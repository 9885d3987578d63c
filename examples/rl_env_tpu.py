"""Device-resident RL-MPC environment: `RlMpcEnv` as one jitted scan.

`rl_env.py` drives the controller from a host loop — one dispatch per call,
fine for CPU development, but the dispatches keep the rate of the compiled
rollout (`tpu_rollout.py`) from ever reaching the learner. This module
re-expresses the
SAME environment semantics (knob application, decimated control cycle,
kinematic-feet SRBD plant, fall detection, masked reset, reward) as pure
functions of an explicit carry, so a whole population evaluation — every
env running its own policy parameters, exactly the per-env knob batching
the reference advertises (`mpc_wrapper.py:48-64`) — compiles into ONE
device program with `lax.scan` over RL steps.

Step-for-step parity with the host `RlMpcEnv` is pinned by
`tests/test_train_rl_mpc.py::test_device_env_matches_host_env`.

Layout notes:
  * obs (B, 14): [rpy(3), height, w_w(3), v_w(3), contact_state(2),
    swing_phase(2)] — `rl_env.RlMpcEnv._rl_obs`.
  * action (B, 10): see `rl_env.py` — knobs are residuals on nominals.
  * policy: per-env linear map w (B, 10, 14), action = tanh(w @ obs).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from biped_pympc_tpu import ControllerConf, MPCConf
from biped_pympc_tpu.control.controller import BipedControllerCore, ControllerState

from tpu_rollout import (  # noqa: E402  (examples-local module)
    _quat_from_euler, make_affine_rk4_step,
)

OBS_DIM = 14
ACT_DIM = 10
ACT_DIM_MATRIX = 16  # with matrix_residual=True (extra B-residual dims)


class EnvCarry(NamedTuple):
    state: ControllerState  # controller pytree (B leaves)
    x: jnp.ndarray  # (B, 12) plant body state
    foot_w: jnp.ndarray  # (B, 2, 3) world foot positions


def make_device_env(num_envs: int, vx_cmd: float = 0.3,
                    solver: str = "auto", height: float = 0.55,
                    plant_mass_scale: float = 1.0,
                    matrix_residual: bool = False,
                    plant_force_scale=None):
    """Build (env_step, reset_all, rl_obs, core) for a device-resident env.

    env_step(carry, action) -> (carry, reward (B,), done (B,) bool)
        One RL step = one MPC cycle (`decimation` 1 kHz ticks), identical
        in sequence to `rl_env.RlMpcEnv.step`: apply knobs, tick the
        decimated loop (ingest -> MPC@tick0 -> low-level -> plant), score,
        and masked-reset fallen envs.
    reset_all() -> carry at the nominal standing state, command applied.
    rl_obs(carry) -> (B, 14) policy observation.

    plant_mass_scale != 1 injects model error: the PLANT integrates with
    a scaled body mass while the MPC keeps the nominal model — the
    RL-MPC hybrid task the reference is built for (`README.md:1-3`):
    the policy must learn SRBD residual accelerations (action dims 4:10)
    that make the nominal model match the true plant (e.g. a negative z
    residual makes the MPC believe gravity is stronger, commanding the
    extra force a heavier plant needs).

    matrix_residual=True mirrors the host env's knob (`rl_env.RlMpcEnv`):
    the action grows to 16 dims, with [10:13]/[13:16] driving the
    (12, 12) B-matrix residual through the diagonal force/moment-
    effectiveness parameterization (`set_srbd_residual` made real in
    round 4). The residual state leaves exist from reset, so the program
    structure is fixed — no recompile mid-training.

    plant_force_scale: optional (3,) per-axis GRF effectiveness of the
    PLANT (e.g. (1, 1, 0.75): only 75% of commanded vertical force is
    delivered — weakened actuators / miscalibrated force mapping). The
    MPC keeps the nominal model, so the error is PROPORTIONAL TO THE
    COMMANDED FORCE — a structured, input-dependent model error that the
    constant acceleration residuals cannot represent but the B-matrix
    force-effectiveness residual dims parameterize exactly.
    """
    import dataclasses

    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    mpc_cfg = MPCConf(solver=solver, verbose=False)
    core = BipedControllerCore(cfg, mpc_cfg, gait_id=2)
    robot = core.robot
    dof = robot.num_dof
    decimation = mpc_cfg.decimation
    plant_robot = dataclasses.replace(
        robot, mass=robot.mass * plant_mass_scale)
    rk4_step = make_affine_rk4_step(plant_robot, mpc_cfg.dt)

    hip_l = robot.hip_horizontal_location(0, jnp.float32)
    hip_r = robot.hip_horizontal_location(1, jnp.float32)

    def _nominal_plant(b):
        x = jnp.zeros((b, 12), jnp.float32).at[:, 5].set(height)
        foot_w = jnp.zeros((b, 2, 3), jnp.float32)
        foot_w = foot_w.at[:, 0, :2].set(hip_l[:2])
        foot_w = foot_w.at[:, 1, :2].set(hip_r[:2])
        return x, foot_w

    def reset_all() -> EnvCarry:
        state = core.init_state(num_envs)
        if matrix_residual:
            z = jnp.zeros((num_envs, 12, 12), jnp.float32)
            state = state._replace(residual_A=z, residual_B=z)
        twist = jnp.zeros((num_envs, 3), jnp.float32).at[:, 0].set(vx_cmd)
        state = core.set_command(
            state, twist, jnp.full((num_envs,), height, jnp.float32))
        x, foot_w = _nominal_plant(num_envs)
        return EnvCarry(state, x, foot_w)

    def assemble_obs(x, foot_w):
        """(B, 13+6*dof) controller observation + per-env rotations
        (`srbd_plant.SrbdPlant.observation`)."""
        def one(xi, feet):
            quat = _quat_from_euler(xi[:3])
            from biped_pympc_tpu.utils.maths import quat_to_rotmat
            rot = quat_to_rotmat(quat)
            v_b = rot.T @ xi[9:12]
            w_b = rot.T @ xi[6:9]
            foot_b = (feet - xi[3:6]) @ rot
            q_l = robot.analytical_ik(foot_b[0], 0)
            q_r = robot.analytical_ik(foot_b[1], 1)
            obs = jnp.concatenate([
                xi[3:6], quat, v_b, w_b, q_l, q_r,
                jnp.zeros(4 * dof, xi.dtype),
            ])
            return obs, rot
        return jax.vmap(one)(x, foot_w)

    fscale = None
    if plant_force_scale is not None:
        fscale = jnp.asarray(plant_force_scale, jnp.float32).reshape(1, 1, 3)

    def plant_tick(x, foot_w, rot, grf, contact, p_des_b):
        """Foot pinning + contact-gated GRFs + closed-form RK4
        (`srbd_plant.SrbdPlant.step`; the affine closed form equals the
        literal 4-stage RK4 — pinned by tests/test_tpu_rollout.py)."""
        p_des_w = jnp.einsum("bij,blj->bli", rot, p_des_b) + x[:, None, 3:6]
        foot_w = jnp.where(contact[:, :, None] > 0.5, foot_w, p_des_w)
        foot_w = foot_w.at[:, :, 2].set(jnp.maximum(foot_w[:, :, 2], 0.0))
        gate = jnp.concatenate(
            [contact[:, 0:1], contact[:, 1:2]] * 2, axis=1)
        u = grf.reshape(-1, 4, 3) * gate[:, :, None]
        if fscale is not None:
            # Per-axis force-effectiveness model error: the plant delivers
            # scaled FORCES (blocks 0-1 of [F_L, F_R, M_L, M_R]).
            u = u.at[:, :2].multiply(fscale)
        return rk4_step(x, u, foot_w, rot), foot_w

    def env_step(carry: EnvCarry, action: jnp.ndarray):
        state, x, foot_w = carry
        action = jnp.clip(jnp.asarray(action, jnp.float32), -1.0, 1.0)

        # DRL knobs (`rl_env.RlMpcEnv.step`, `mpc_wrapper.py:48-64`).
        state = state._replace(
            dt_mpc=0.025 + 0.005 * action[:, 0],
            foot_height=0.08 + 0.04 * action[:, 1],
            cp1=1.0 / 3.0 + 0.15 * action[:, 2],
            cp2=2.0 / 3.0 + 0.15 * action[:, 3],
            residual_lin_accel=1.0 * action[:, 4:7],
            residual_ang_accel=1.0 * action[:, 7:10],
        )
        if matrix_residual:
            # Diagonal B-residual parameterization, matching the host
            # env: force effectiveness on the v_dot rows, moment
            # effectiveness on the omega_dot rows, per axis per env.
            # (Batch from the action, NOT num_envs: under shard_map the
            # step sees only its device's shard.)
            b = action.shape[0]
            eye3 = jnp.eye(3, dtype=jnp.float32)
            f_scale = 0.3 / float(robot.mass)
            i_inv = 1.0 / jnp.asarray(
                np.diag(np.asarray(robot.i_body)), jnp.float32)
            fd = f_scale * action[:, 10:13]  # (B, 3)
            md = 0.3 * i_inv[None] * action[:, 13:16]
            rb = jnp.zeros((b, 12, 12), jnp.float32)
            rb = rb.at[:, 9:12, 0:3].set(fd[:, :, None] * eye3)
            rb = rb.at[:, 9:12, 3:6].set(fd[:, :, None] * eye3)
            rb = rb.at[:, 6:9, 6:9].set(md[:, :, None] * eye3)
            rb = rb.at[:, 6:9, 9:12].set(md[:, :, None] * eye3)
            state = state._replace(residual_B=rb)

        def tick(c, k):
            state, x, foot_w, grf = c
            obs, rot = assemble_obs(x, foot_w)
            state = core.ingest_state(state, obs)

            def do_mpc(s):
                s2, out = core.run_mpc(s)
                return s2, out.grf_world

            state, grf = jax.lax.cond(
                k == 0, do_mpc, lambda s: (s, grf), state)
            state = core.run_lowlevel(state)
            contact = (state.contact_phase != -1).astype(x.dtype)
            p_des_b = state.leg_cmd.p_des
            x, foot_w = plant_tick(x, foot_w, rot, grf, contact, p_des_b)
            return (state, x, foot_w, grf), None

        grf0 = jnp.zeros((action.shape[0], 12), jnp.float32)
        (state, x, foot_w, _), _ = jax.lax.scan(
            tick, (state, x, foot_w, grf0), jnp.arange(decimation))

        # Fall detection + reward (`rl_env.RlMpcEnv.step` with its 0.55
        # constants generalized to the commanded height: the band is
        # height -0.25/+0.25 and the height bonus tracks the command, so
        # a non-default height is rewarded, not fought).
        fell = (
            (jnp.abs(x[:, 0:2]).max(axis=1) > 0.5)
            | (x[:, 5] < height - 0.25)
            | (x[:, 5] > height + 0.25)
        )
        vx_err = x[:, 9] - vx_cmd
        reward = (
            1.0
            - 2.0 * jnp.abs(vx_err)
            - 0.5 * jnp.abs(x[:, 5] - height)
            - 5.0 * fell.astype(jnp.float32)
        )

        # Masked reset of fallen envs (plant + controller), matching the
        # host env's `plant.reset(fell); ctrl.reset(fell)`. Shapes from
        # the carry (shard-size-agnostic under shard_map).
        state = core.reset(state, fell)
        x_nom, foot_nom = _nominal_plant(x.shape[0])
        x = jnp.where(fell[:, None], x_nom, x)
        foot_w = jnp.where(fell[:, None, None], foot_nom, foot_w)
        return EnvCarry(state, x, foot_w), reward, fell

    def rl_obs(carry: EnvCarry) -> jnp.ndarray:
        """(B, 14) policy observation (`rl_env.RlMpcEnv._rl_obs`)."""
        state, x, _ = carry
        contact_state = (state.contact_phase != -1).astype(jnp.float32)
        sp = state.swing_phase
        swing_phase = jnp.where(sp == -1, 0.0, sp)
        return jnp.concatenate(
            [x[:, 0:3], x[:, 5:6], x[:, 6:12], contact_state, swing_phase],
            axis=1,
        )

    return env_step, reset_all, rl_obs, core


def make_rollout(env_step, rl_obs, steps: int):
    """rollout(carry, w_per_env) -> (carry, returns (B,)).

    Per-env linear policies evaluated inside the scan: one dispatch rolls
    the entire population for `steps` RL steps (steps * decimation
    env-ticks each).
    """

    def rollout(carry: EnvCarry, w_per_env: jnp.ndarray):
        def step(c, _):
            carry, total = c
            obs = rl_obs(carry)
            action = jnp.tanh(
                jnp.einsum("bao,bo->ba", w_per_env, obs))
            carry, reward, _ = env_step(carry, action)
            return (carry, total + reward), None

        with jax.default_matmul_precision("highest"):  # no TF32 anywhere
            (carry, total), _ = jax.lax.scan(
                step, (carry, jnp.zeros(obs_batch(carry), jnp.float32)),
                None, length=steps)
        return carry, total

    def obs_batch(carry):
        return carry.x.shape[0]

    return jax.jit(rollout)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    env_step, reset_all, rl_obs, _ = make_device_env(n)
    rollout = make_rollout(env_step, rl_obs, steps)
    carry = reset_all()
    w = jnp.zeros((n, ACT_DIM, OBS_DIM), jnp.float32)
    carry, returns = rollout(carry, w)
    print(f"{steps} RL steps x {n} envs in one dispatch; "
          f"mean return {np.asarray(returns).mean():.3f}")
