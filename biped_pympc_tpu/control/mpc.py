"""Convex-MPC stance controller: reference trajectory, QP build, PDIPM solve.

Functional re-expression of the reference's `BaseMPCController` machinery and
the CusADi backend's `run()`
(`/root/reference/biped_pympc/convex_mpc/base_controller.py:61-266`,
`mpc_controller_cusadi.py:43-205`), with the CasADi/CUDA kernel pipeline
replaced by closed-form QP assembly (`ops/qp.py`) and the batched JAX PDIPM
(`ops/pdipm.py`). Single-env; vmapped by the controller.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from biped_pympc_tpu.control.estimator import EstimatorData
from biped_pympc_tpu.models.robot import RobotSpec
from biped_pympc_tpu.models.srbd import SrbdLin
from biped_pympc_tpu.ops import pdipm
from biped_pympc_tpu.ops import qp as qps


class DesiredState(NamedTuple):
    """Body-frame command (`robot_data.py:41-66`)."""

    velocity_b: jnp.ndarray  # (3,)
    ang_velocity_b: jnp.ndarray  # (3,)
    height: jnp.ndarray  # ()


def init_desired_state(dtype=jnp.float32, height: float = 0.55) -> DesiredState:
    return DesiredState(
        velocity_b=jnp.zeros(3, dtype=dtype),
        ang_velocity_b=jnp.zeros(3, dtype=dtype),
        height=jnp.asarray(height, dtype=dtype),
    )


class MpcMemory(NamedTuple):
    """Cross-solve latches (`base_controller.py:48,71-72`)."""

    first_run: jnp.ndarray  # () bool
    world_position_desired: jnp.ndarray  # (3,)
    yaw_desired: jnp.ndarray  # ()


def init_memory(dtype=jnp.float32) -> MpcMemory:
    return MpcMemory(
        first_run=jnp.asarray(True),
        world_position_desired=jnp.zeros(3, dtype=dtype),
        yaw_desired=jnp.zeros((), dtype=dtype),
    )


def reset_memory(mem: MpcMemory, do_reset: jnp.ndarray) -> MpcMemory:
    """Masked reset: re-arm the first-run latch (`base_controller.py:259-266`)."""
    return mem._replace(first_run=jnp.where(do_reset, True, mem.first_run))


class MpcOutput(NamedTuple):
    wrench: jnp.ndarray  # (2, 6) body-frame feed-forward foot wrench
    cost: jnp.ndarray  # () realized QP cost (reference cusadi returns 0)
    x_ref: jnp.ndarray  # (T, 12) reference trajectory
    grf_world: jnp.ndarray  # (12,) raw u_0 = [F_L, F_R, M_L, M_R], world frame
    solution: jnp.ndarray  # (nz,) full QP primal solution
    residuals: jnp.ndarray  # (4,) final PDIPM residual norms + mu


def reference_trajectory(
    mem: MpcMemory,
    est: EstimatorData,
    des: DesiredState,
    dt_mpc: jnp.ndarray,
    horizon: int,
    decimation_dt: float,
    yaw_wrap: bool = False,
):
    """Open-loop reference integration (`base_controller.py:166-257`).

    Returns (new_mem, x_ref (T, 12)). Quirks preserved from the reference:
      * the desired-position knot integrates the *body-frame* velocity
        components directly (`:221-222`);
      * position xy tracks the open-loop knot only when |v_des_x| < 1e-2
        ("stationary"), otherwise the current position (`:226,241-247`);
      * x_ref[k] is the target for knot x_{k+1} (one-step offset by
        construction of the QP, `srbd_constraints.py:65`).
    """
    dtype = est.root_position.dtype

    # First-run latch (`base_controller.py:166-176`).
    wpd = jnp.where(mem.first_run, est.root_position, mem.world_position_desired)
    yaw_des = jnp.where(mem.first_run, est.root_euler[2], mem.yaw_desired)

    # Open-loop knot integration (`base_controller.py:218-224`).
    wpd = wpd.at[0].add(decimation_dt * des.velocity_b[0])
    wpd = wpd.at[1].add(decimation_dt * des.velocity_b[1])
    wpd = wpd.at[2].set(des.height)
    yaw_des = yaw_des + decimation_dt * des.ang_velocity_b[2]

    if yaw_wrap:
        # Omnidirectional mode: the measured yaw (atan2 of the quaternion)
        # wraps to (-pi, pi] while this open-loop integrator is unbounded —
        # at the wrap the raw yaw error jumps by 2*pi and the QP commands a
        # violent spin (measured: NaN blow-ups the moment yaw crosses pi).
        # Store the integrator wrapped and reference yaw RELATIVE to the
        # measured yaw so the tracking error is always the short way around.
        two_pi = 2.0 * jnp.pi
        wrap = lambda a: a - two_pi * jnp.round(a / two_pi)
        yaw_des = est.root_euler[2] + wrap(yaw_des - est.root_euler[2])

    stationary = jnp.abs(des.velocity_b[0]) < 1e-2
    t = dt_mpc * jnp.arange(horizon, dtype=dtype)

    v_des_w = est.rotation_body @ des.velocity_b
    x_ref = jnp.zeros((horizon, 12), dtype=dtype)
    x_ref = x_ref.at[:, 2].set(yaw_des + des.ang_velocity_b[2] * t)
    xy_base = jnp.where(stationary, wpd[:2], est.root_position[:2])
    x_ref = x_ref.at[:, 3].set(xy_base[0] + v_des_w[0] * t)
    x_ref = x_ref.at[:, 4].set(xy_base[1] + v_des_w[1] * t)
    x_ref = x_ref.at[:, 5].set(des.height)
    x_ref = x_ref.at[:, 8].set(des.ang_velocity_b[2])
    x_ref = x_ref.at[:, 9].set(v_des_w[0])
    x_ref = x_ref.at[:, 10].set(v_des_w[1])

    new_mem = MpcMemory(
        first_run=jnp.zeros((), dtype=bool),
        world_position_desired=wpd,
        yaw_desired=yaw_des,
    )
    return new_mem, x_ref


def build_mpc_qp(
    robot: RobotSpec,
    mem: MpcMemory,
    est: EstimatorData,
    des: DesiredState,
    contact_table: jnp.ndarray,
    dt_mpc: jnp.ndarray,
    residual_lin_accel: jnp.ndarray,
    residual_ang_accel: jnp.ndarray,
    q_weights: jnp.ndarray,
    r_weights: jnp.ndarray,
    horizon: int,
    decimation_dt: float,
    euler_rate_mode: str = "rt_omega",
    f_max=qps.F_MAX,
    mu=None,
    contact_frame: str = "world",
    residual_A=None,
    residual_B=None,
    lt=None,
    lh=None,
):
    """Per-env QP assembly half of the MPC step (vmapped by the caller).

    f_max and mu may be Python floats or per-env traced scalars (DRL /
    domain-randomization knobs); mu=None uses the robot's default.

    lt / lh: toe / heel line-contact lever arms [m]; None uses the robot's
    real foot geometry (`RobotSpec.lt/lh` — the reference hardcodes
    HECTOR's values for every robot, `srbd_constraints.py:161-162`).

    residual_A / residual_B: optional (12, 12) learned dynamics residuals
    added to the continuous-time SRBD linearization before discretization
    (the reference's declared-but-unbuilt `set_srbd_residual` interface,
    `mpc_wrapper.py:66-67`). None keeps the exact residual-free program.

    contact_frame: "world" (reference parity) keeps the contact constraint
    rows in fixed world axes — the reference's Mx=0 equality and toe/heel
    line-contact rows assume the foot line is world-x-aligned, which is
    only true for yaw ~ 0 (mod pi); at yaw ~ pi/2 the QP forbids exactly
    the pitch moment that provides toe-heel authority and the robot falls
    (measured). "yaw" expresses u in YAW-ALIGNED axes instead — the
    constraint ROWS stay constant (so the fused kernels are untouched)
    while Bd's input columns rotate by R_z(yaw) at assembly and the
    solution rotates back in postprocess; turning then works at any
    heading. Also enables yaw-error wrapping in the reference trajectory.

    Split out from the solve so the fused solver can run on the whole
    batch at once between the vmapped build and postprocess phases.
    Returns (new_mem, x_ref, qp).
    """
    dtype = est.root_position.dtype
    new_mem, x_ref = reference_trajectory(
        mem, est, des, dt_mpc, horizon, decimation_dt,
        yaw_wrap=contact_frame == "yaw",
    )

    rot = est.rotation_body
    i_world = rot @ jnp.asarray(robot.i_body, dtype=dtype) @ rot.T
    lin = SrbdLin(
        rot_body=rot,
        inertia_world=i_world,
        body_pos=est.root_position,
        foot_pos=est.foot_position_w,
        mass=jnp.asarray(robot.mass, dtype=dtype),
        residual_lin_accel=residual_lin_accel,
        residual_ang_accel=residual_ang_accel,
        residual_A=residual_A,
        residual_B=residual_B,
    )
    x0 = jnp.concatenate(
        [est.root_euler, est.root_position, est.root_angular_velocity_w,
         est.root_velocity_w]
    )
    mu_v = jnp.asarray(robot.mu if mu is None else mu, dtype=dtype)
    lt_v = jnp.asarray(robot.lt if lt is None else lt, dtype=dtype)
    lh_v = jnp.asarray(robot.lh if lh is None else lh, dtype=dtype)
    qp = qps.build_qp(
        lin, x0, x_ref, contact_table.astype(dtype), dt_mpc,
        mu_v, q_weights, r_weights, horizon,
        euler_rate_mode, f_max, lt_v, lh_v,
    )
    if contact_frame == "yaw":
        # u in yaw-aligned axes: rotate Bd's input columns by R_z(yaw)
        # block-per-3-vector ([F_L, F_R, M_L, M_R]). The horizon shares one
        # yaw (same approximation as the reference's horizon-constant
        # rotation/inertia, `base_controller.py:178-199`).
        rz = _rot_z(est.root_euler[2])
        b_yaw = _rotate_u_columns(qp.dyn.B, rz)
        qp = qp._replace(dyn=qp.dyn._replace(B=b_yaw))
    return new_mem, x_ref, qp


def _rot_z(yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, -s, z]), jnp.stack([s, c, z]), jnp.stack([z, z, o]),
    ])


def _rotate_u_columns(b_mat: jnp.ndarray, rz: jnp.ndarray) -> jnp.ndarray:
    """B @ blockdiag(rz, rz, rz, rz) without materializing the 12x12."""
    cols = b_mat.reshape(12, 4, 3)
    return jnp.einsum("rbj,ij->rbi", cols, rz.T).reshape(12, 12)


def postprocess_solution(
    qp: qps.StageQP,
    sol: pdipm.PdipmResult,
    rot: jnp.ndarray,
    x_ref: jnp.ndarray,
    horizon: int,
    contact_frame: str = "world",
) -> MpcOutput:
    """Extract u_0 and transform the wrench (`mpc_controller_cusadi.py:184-203`).

    Per-env (vmapped by the caller). With contact_frame="yaw" the raw
    solution's u is in yaw-aligned axes (see `build_mpc_qp`) and is rotated
    back to world here, so every MpcOutput field keeps world semantics.
    """
    nx = qps.NX
    u0 = sol.x[nx * horizon: nx * horizon + qps.NU]
    if contact_frame == "yaw":
        # The unactuated ankle-roll axis is the YAW-frame x: zero it there
        # (it is the Mx=0 equality axis, so this is a numerical cleanup),
        # then rotate back to world. The reference's world-axis Mx zeroing
        # would instead discard a real component of My at yaw != 0.
        yaw = jnp.arctan2(rot[1, 0], rot[0, 0])
        rz = _rot_z(yaw)
        u0r = u0.reshape(4, 3).at[2:, 0].set(0.0)
        u0 = jnp.einsum("ij,bj->bi", rz, u0r).reshape(12)
        grf = u0.reshape(4, 3)  # [F_L, F_R, M_L, M_R] world frame
        grm = grf[2:]
    else:
        grf = u0.reshape(4, 3)  # [F_L, F_R, M_L, M_R] world frame
        grm = grf[2:].at[:, 0].set(0.0)  # zero Mx (unactuated)
    f_body = (rot.T @ grf[:2].T).T
    m_body = (rot.T @ grm.T).T
    wrench = jnp.stack(
        [
            jnp.concatenate([-f_body[0], -m_body[0]]),
            jnp.concatenate([-f_body[1], -m_body[1]]),
        ]
    )
    cost = 0.5 * jnp.dot(sol.x, qps.h_diag(qp) * sol.x) + jnp.dot(qp.f, sol.x)
    return MpcOutput(
        wrench=wrench,
        cost=cost,
        x_ref=x_ref,
        grf_world=u0,
        solution=sol.x,
        residuals=sol.residuals,
    )


def solve_mpc(
    robot: RobotSpec,
    mem: MpcMemory,
    est: EstimatorData,
    des: DesiredState,
    contact_table: jnp.ndarray,
    dt_mpc: jnp.ndarray,
    residual_lin_accel: jnp.ndarray,
    residual_ang_accel: jnp.ndarray,
    q_weights: jnp.ndarray,
    r_weights: jnp.ndarray,
    horizon: int,
    decimation_dt: float,
    opts: pdipm.PdipmOptions,
    euler_rate_mode: str = "rt_omega",
    f_max: float = qps.F_MAX,
    residual_A=None,
    residual_B=None,
):
    """Full MPC step for one env (`mpc_controller_cusadi.py:43-205`).

    Returns (new_mem, MpcOutput).
    """
    dtype = est.root_position.dtype
    new_mem, x_ref = reference_trajectory(
        mem, est, des, dt_mpc, horizon, decimation_dt
    )

    # Linearization point (`base_controller.py:178-199` repeats the current
    # state across the horizon; the qp_former consumes one point).
    rot = est.rotation_body
    i_world = rot @ jnp.asarray(robot.i_body, dtype=dtype) @ rot.T
    lin = SrbdLin(
        rot_body=rot,
        inertia_world=i_world,
        body_pos=est.root_position,
        foot_pos=est.foot_position_w,
        mass=jnp.asarray(robot.mass, dtype=dtype),
        residual_lin_accel=residual_lin_accel,
        residual_ang_accel=residual_ang_accel,
        residual_A=residual_A,
        residual_B=residual_B,
    )
    x0 = jnp.concatenate(
        [est.root_euler, est.root_position, est.root_angular_velocity_w,
         est.root_velocity_w]
    )  # `base_controller.py:201-211`

    qp = qps.build_qp(
        lin, x0, x_ref, contact_table.astype(dtype), dt_mpc,
        jnp.asarray(robot.mu, dtype=dtype), q_weights, r_weights, horizon,
        euler_rate_mode, f_max,
        jnp.asarray(robot.lt, dtype=dtype), jnp.asarray(robot.lh, dtype=dtype),
    )
    sol = pdipm.solve(qp, opts)

    # Extract u_0 and transform the wrench (`mpc_controller_cusadi.py:184-203`).
    nx = qps.NX
    u0 = sol.x[nx * horizon: nx * horizon + qps.NU]
    grf = u0.reshape(4, 3)  # [F_L, F_R, M_L, M_R] world frame
    grm = grf[2:].at[:, 0].set(0.0)  # zero Mx (unactuated)
    f_body = (rot.T @ grf[:2].T).T
    m_body = (rot.T @ grm.T).T
    wrench = jnp.stack(
        [
            jnp.concatenate([-f_body[0], -m_body[0]]),
            jnp.concatenate([-f_body[1], -m_body[1]]),
        ]
    )

    # Realized cost 0.5 z^T H z + f^T z (the reference cusadi backend skips
    # this and returns 0, `mpc_controller_cusadi.py:185`; qpth computes it).
    cost = 0.5 * jnp.dot(sol.x, qps.h_diag(qp) * sol.x) + jnp.dot(qp.f, sol.x)

    return new_mem, MpcOutput(
        wrench=wrench,
        cost=cost,
        x_ref=x_ref,
        grf_world=u0,
        solution=sol.x,
        residuals=sol.residuals,
    )
