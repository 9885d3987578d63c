"""Whole-rollout closed-loop walking as ONE jitted device program.

`closed_loop_sim.py` drives the identical control stack from a host loop —
one dispatch per 1 kHz tick, the way the reference runs inside IsaacLab
(one CUDA launch per kernel per tick, `CusadiFunction.py:40-47`), so the
host loop's dispatch overhead bounds its rate.

This example instead compiles the ENTIRE rollout — MPC solves at 100 Hz,
low-level control and SRBD plant physics at 1 kHz, kinematic foot updates,
all batched over envs — into a single `lax.scan` program: one dispatch per
rollout, zero host round-trips. This is the shape RL training wants on an
accelerator: the policy update is the only host-visible boundary.

Run:  python examples/tpu_rollout.py [num_envs] [seconds]
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from biped_pympc_tpu import ControllerConf, MPCConf
from biped_pympc_tpu.control.controller import BipedControllerCore
from biped_pympc_tpu.models import srbd
from biped_pympc_tpu.utils.maths import quat_to_rotmat


def _quat_from_euler(rpy: jnp.ndarray) -> jnp.ndarray:
    """(3,) rpy -> (4,) wxyz quaternion (R = Rz Ry Rx convention)."""
    r, p, y = rpy[0] / 2, rpy[1] / 2, rpy[2] / 2
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ])


def make_affine_rk4_step(robot, dt: float):
    """Closed-form RK4 step of the affine SRBD model, batched.

    Within a tick the affine model's (`srbd.continuous_dynamics`) angular/
    linear accelerations c_w, c_v are constant and only rpy_dot = R^T w,
    p_dot = v depend on the state, so the literal 4-stage RK4
    (`srbd.rk4_step_generic`, the test oracle) collapses EXACTLY to
        w+ = w + dt c_w                v+ = v + dt c_v
        rpy+ = rpy + dt R^T (w + dt/2 c_w)
        p+   = p + dt (v + dt/2 c_v)
    — a handful of (B, 3) ops instead of a memory-bound (B, 12, 12)
    affine-matrix materialization every tick. Equality to rk4_step_generic is pinned
    by tests/test_tpu_rollout.py::test_affine_rk4_closed_form_matches_oracle.
    """
    i_body_inv = srbd._inv3(jnp.asarray(robot.i_body, jnp.float32))
    mass = jnp.float32(robot.mass)
    g_vec = jnp.array([0.0, 0.0, -srbd.GRAVITY], jnp.float32)

    def step(x, u, foot_w, rot):
        """x (B,12), u (B,4,3) [F_L,F_R,M_L,M_R] world, foot_w (B,2,3),
        rot (B,3,3) body-to-world at the linearization point."""
        rpy, pos = x[:, 0:3], x[:, 3:6]
        w, v = x[:, 6:9], x[:, 9:12]

        # Torque about the body: skew(p_f - p_b) F + M; then
        # I_w^{-1} tau = R I_b^{-1} R^T tau (closed-form 3x3 inverse once).
        r_feet = foot_w - pos[:, None, :]  # (B, 2, 3)
        tau = (
            jnp.cross(r_feet[:, 0], u[:, 0]) + jnp.cross(r_feet[:, 1], u[:, 1])
            + u[:, 2] + u[:, 3]
        )  # (B, 3) world frame
        c_w = jnp.einsum("bij,jk,blk,bl->bi", rot, i_body_inv, rot, tau)
        c_v = (u[:, 0] + u[:, 1]) / mass + g_vec

        # rt_omega mode: rpy_dot = R^T w (the shipped CUDA convention).
        w_mid = w + (dt / 2) * c_w
        rpy_dot = jnp.einsum("bji,bj->bi", rot, w_mid)
        return jnp.concatenate([
            rpy + dt * rpy_dot,
            pos + dt * (v + (dt / 2) * c_v),
            w + dt * c_w,
            v + dt * c_v,
        ], axis=1)

    return step


def make_rollout(core: BipedControllerCore, seconds: float,
                 obs_ik: str = "robot"):
    """Build (rollout_fn, init_carry). rollout_fn: carry -> (carry, traj).

    traj holds one snapshot per MPC cycle: body state x (B, 12).
    The physics/foot-update rules replicate `closed_loop_sim.simulate`
    tick-for-tick (ingest -> [MPC on cycle ticks] -> low-level -> foot
    pinning -> SRBD RK4), so behavior matches the host-loop demo.

    obs_ik: IK used as the encoder stand-in when assembling observations —
    "robot" (default, the controller robot's own IK) or "newton" (exact
    T1 Gauss-Newton IK for the observation only; see
    `closed_loop_sim.simulate`).
    """
    robot = core.robot
    dt = core.mpc_cfg.dt
    decimation = core.mpc_cfg.decimation
    cycles = int(seconds / dt) // decimation
    dof = robot.num_dof
    rk4_step = make_affine_rk4_step(robot, dt)
    if obs_ik == "newton":
        from biped_pympc_tpu.models import t1 as _t1

        obs_ik_fn = _t1.analytical_ik_newton
    else:
        obs_ik_fn = robot.analytical_ik

    def assemble_obs(x, foot_w):
        """Batched controller observation + per-env rotation matrices."""
        def one(xi, feet):
            quat = _quat_from_euler(xi[:3])
            rot = quat_to_rotmat(quat)
            v_b = rot.T @ xi[9:12]
            w_b = rot.T @ xi[6:9]
            foot_b = (feet - xi[3:6]) @ rot  # R^T (p_w - root) per leg
            q_l = obs_ik_fn(foot_b[0], 0)
            q_r = obs_ik_fn(foot_b[1], 1)
            obs = jnp.concatenate([
                xi[3:6], quat, v_b, w_b, q_l, q_r,
                jnp.zeros(4 * dof, xi.dtype),  # qd, tau: zero like the host demo
            ])
            return obs, rot
        return jax.vmap(one)(x, foot_w)

    def plant_tick(x, foot_w, rot, grf, contact, p_des_b):
        """Foot pinning + contact-gated GRFs + one closed-form RK4 step."""
        p_des_w = jnp.einsum("bij,blj->bli", rot, p_des_b) + x[:, None, 3:6]
        foot_w = jnp.where(contact[:, :, None] > 0.5, foot_w, p_des_w)
        foot_w = foot_w.at[:, :, 2].set(jnp.maximum(foot_w[:, :, 2], 0.0))

        gate = jnp.concatenate(
            [contact[:, 0:1], contact[:, 1:2]] * 2, axis=1
        )  # (B, 4) for [F_L, F_R, M_L, M_R]
        u = grf.reshape(-1, 4, 3) * gate[:, :, None]
        return rk4_step(x, u, foot_w, rot), foot_w

    def lowlevel_and_plant(state, x, foot_w, grf, rot):
        state = core.run_lowlevel(state)
        contact = (state.contact_phase != -1).astype(x.dtype)
        p_des_b = state.leg_cmd.p_des
        x, foot_w = plant_tick(x, foot_w, rot, grf, contact, p_des_b)
        return state, x, foot_w

    def cycle(carry, _):
        state, x, foot_w = carry
        # Tick 0 of the cycle: ingest + 100 Hz MPC solve.
        obs, rot = assemble_obs(x, foot_w)
        state = core.ingest_state(state, obs)
        state, out = core.run_mpc(state)
        grf = out.grf_world  # (B, 12) world frame, held for the cycle
        state, x, foot_w = lowlevel_and_plant(state, x, foot_w, grf, rot)

        # Remaining decimation-1 low-level ticks at 1 kHz.
        def tick(c, _):
            state, x, foot_w = c
            obs, rot = assemble_obs(x, foot_w)
            state = core.ingest_state(state, obs)
            state, x, foot_w = lowlevel_and_plant(state, x, foot_w, grf, rot)
            return (state, x, foot_w), None

        (state, x, foot_w), _ = jax.lax.scan(
            tick, (state, x, foot_w), None, length=decimation - 1
        )
        return (state, x, foot_w), x

    @jax.jit
    def rollout(carry):
        # Plant matmuls at full precision too (the controller steps pin it
        # themselves), so no float32 product runs in TF32.
        with jax.default_matmul_precision("highest"):
            return jax.lax.scan(cycle, carry, None, length=cycles)

    return rollout, cycles


def init_carry(core: BipedControllerCore, num_envs: int, vx: float,
               height: float):
    robot = core.robot
    state = core.init_state(num_envs)
    twist = jnp.zeros((num_envs, 3), jnp.float32).at[:, 0].set(vx)
    state = core.set_command(
        state, twist, jnp.full((num_envs,), height, jnp.float32)
    )
    x = jnp.zeros((num_envs, 12), jnp.float32).at[:, 5].set(height)
    hip_l = robot.hip_horizontal_location(0, jnp.float32)
    hip_r = robot.hip_horizontal_location(1, jnp.float32)
    foot_w = jnp.zeros((num_envs, 2, 3), jnp.float32)
    foot_w = foot_w.at[:, 0, :2].set(hip_l[:2])
    foot_w = foot_w.at[:, 1, :2].set(hip_r[:2])
    return state, x, foot_w


def run(num_envs: int = 4, seconds: float = 2.0, vx: float = 0.3,
        solver: str = "auto", robot_name: str = "HECTOR",
        height: float | None = None, obs_ik: str = "robot"):
    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    # T1 needs HECTOR-equivalent force authority (see closed_loop_sim.py).
    f_max = 500.0 if robot_name == "HECTOR" else 1450.0
    if height is None:
        height = 0.55 if robot_name == "HECTOR" else 0.62
    core = BipedControllerCore(
        cfg, MPCConf(solver=solver, robot=robot_name, f_max=f_max), gait_id=2
    )
    rollout, cycles = make_rollout(core, seconds, obs_ik=obs_ik)
    carry = init_carry(core, num_envs, vx, height)
    (state, x, foot_w), traj = rollout(carry)
    return np.asarray(traj)  # (cycles, B, 12)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    secs = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    traj = run(n, secs)
    print(f"rolled out {traj.shape[0]} MPC cycles x {n} envs in one dispatch")
    print(f"final body position (env 0): {traj[-1, 0, 3:6].round(3)}")
    print(f"final vx (env 0): {traj[-1, 0, 9]:.3f}")
