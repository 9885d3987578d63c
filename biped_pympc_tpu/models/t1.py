"""Booster T1 biped model — batched JAX kinematics from URDF constants.

Replaces the reference's CPU-only, first-batch-element-only CasADi/Pinocchio
path (`/root/reference/biped_pympc/core/robot/t1.py:96-138`, flagged "TODO:
cpu specific") with fully-batched closed-form chain kinematics.

Chain constants are extracted from `/root/reference/model/t1_serial.urdf`
(leg joints of interest per `casadi/t1_kinematics.py:24-27`, order
[Hip_Pitch, Hip_Roll, Hip_Yaw, Knee_Pitch, Ankle_Pitch, Ankle_Roll]):

  Waist (fixed at q=0):        xyz (0.0625, 0, -0.1155)
  Hip_Pitch   axis y  origin (0, +-0.106, 0)
  Hip_Roll    axis x  origin (0, 0, -0.02)
  Hip_Yaw     axis z  origin (0, 0, -0.081854)
  Knee_Pitch  axis y  origin (-0.014, 0, -0.134)
  Ankle_Pitch axis y  origin (0, 0, -0.28)
  Ankle_Roll  axis x  origin (0, +-0.00025, -0.012)
  foot sole (fixed):           xyz (0, 0, -0.035192) L / (0, 0, -0.03519) R
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from biped_pympc_tpu.ops import linalg
from biped_pympc_tpu.models.chain import (
    SerialChain,
    forward_kinematics as _chain_fk,
    geometric_jacobian as _chain_jac,
)

NUM_DOF = 6
MASS = 40.0  # `t1.py:71`
I_BODY = np.array(
    [[0.5413, 0.0, 0.0], [0.0, 0.5200, 0.0], [0.0, 0.0, 0.0691]]
)  # `t1.py:72-74`
MU = 1.0
# Toe/heel line-contact lever arms from the T1's real foot: the URDF's foot
# collision box is 0.223 m long, centered 0.01 m ahead of the ankle/sole
# origin (`/root/reference/model/t1_serial.urdf:920-927`
# <box size="0.223 0.1 0.03"/> at xyz 0.01 0 -0.015), so
#   lt = 0.223/2 + 0.01 = 0.1215 m,  lh = 0.223/2 - 0.01 = 0.1015 m.
# The reference instead applies HECTOR's 0.07/0.04 to T1
# (`srbd_constraints.py:161-162` — baked into the compiled kernel), halving
# the 40 kg robot's available pitch-moment authority; in closed loop this is
# a primary cause of its height/velocity tracking gap.
LT = 0.1215
LH = 0.1015
KP = (20.0, 20.0, 20.0, 20.0, 15.0, 15.0)  # `t1.py:47`
KD = (1.0, 1.0, 0.7, 0.7, 0.7, 0.7)  # `t1.py:48`
TORQUE_LIMIT = (
    33.5, 33.5, 33.5, 67.0, 33.5, 33.5, 33.5, 33.5, 33.5, 67.0, 33.5, 33.5
)  # `t1.py:49`


def _leg_chain(side: float) -> SerialChain:
    return SerialChain(
        base_offset=np.array([0.0625, 0.0, -0.1155]),
        joint_offsets=np.array(
            [
                [0.0, side * 0.106, 0.0],
                [0.0, 0.0, -0.02],
                [0.0, 0.0, -0.081854],
                [-0.014, 0.0, -0.134],
                [0.0, 0.0, -0.28],
                [0.0, side * 0.00025, -0.012],
            ]
        ),
        axes="yxzyyx",
        tip_offset=np.array([0.0, 0.0, -0.035192 if side > 0 else -0.03519]),
    )


_CHAINS = (_leg_chain(1.0), _leg_chain(-1.0))  # (left, right)


def forward_kinematics(q: jnp.ndarray, leg: int):
    return _chain_fk(_CHAINS[leg], q)


def foot_position(q: jnp.ndarray, leg: int) -> jnp.ndarray:
    """(6,) joint angles -> (3,) foot sole position in torso frame."""
    return _chain_fk(_CHAINS[leg], q)[0]


def contact_jacobian(q: jnp.ndarray, leg: int) -> jnp.ndarray:
    """(6, 6) LOCAL_WORLD_ALIGNED frame Jacobian at the foot sole."""
    return _chain_jac(_CHAINS[leg], q)


def analytical_ik(p_foot_b: jnp.ndarray, leg: int) -> jnp.ndarray:
    """Closed-form IK with hip yaw and ankle roll fixed to 0.

    Re-expression of `t1.py:140-215` with the same constants, clamps and
    epsilons so trajectories match the reference.
    """
    dtype = p_foot_b.dtype
    side = 1.0 if leg == 0 else -1.0  # `t1.py:155`

    r_torso_to_hip = jnp.asarray(
        [0.0625, side * 0.106, -0.1155], dtype=dtype
    )
    r_ankle_roll_to_ee = jnp.asarray(
        [0.0, side * 0.00025, -0.035192], dtype=dtype
    )
    l1 = 0.02 + 0.081854 + 0.134  # hip -> knee
    l2 = 0.28 + 0.012  # knee -> ankle roll
    knee_x_offset = -0.014

    v = p_foot_b - r_torso_to_hip - r_ankle_roll_to_ee
    hip_roll = jnp.arctan2(v[1], -v[2])

    cr, sr = jnp.cos(hip_roll), jnp.sin(hip_roll)
    xs = v[0] - knee_x_offset
    zs = -v[1] * sr + v[2] * cr

    d = jnp.sqrt(xs * xs + zs * zs)
    cos_beta = jnp.clip((l1 * l1 + d * d - l2 * l2) / (2 * l1 * d + 1e-6), -1.0, 1.0)
    beta = jnp.arccos(cos_beta)
    cos_k = jnp.clip((l1 * l1 + l2 * l2 - d * d) / (2 * l1 * l2 + 1e-6), -1.0, 1.0)
    knee_pitch = jnp.pi - jnp.arccos(cos_k)
    alpha = jnp.arctan2(xs, -zs)
    hip_pitch = alpha - beta
    ankle_pitch = -(hip_pitch + knee_pitch)

    zero = jnp.zeros((), dtype=dtype)
    return jnp.stack([hip_pitch, hip_roll, zero, knee_pitch, ankle_pitch, zero])


def analytical_ik_newton(p_foot_b: jnp.ndarray, leg: int,
                         iterations: int = 10) -> jnp.ndarray:
    """Accurate T1 IK: crude analytic seed + damped Gauss-Newton refinement.

    The reference's T1 IK is a planar approximation with decimeter-level
    FK(IK(p)) error at bent poses (`t1.py:190-202` ignores how the knee
    x-offset rotates with hip pitch), which biases the estimator's foot
    positions and degrades T1 control. This refiner runs a few Gauss-Newton
    steps on the *exact* chain FK, updating only the pitch/roll joints (hip
    yaw and ankle roll stay 0, preserving the reference convention):

        dq = J4^T (J4 J4^T + lambda I)^-1 (p_des - FK(q))

    with J4 the position Jacobian restricted to [hip_pitch, hip_roll, knee,
    ankle_pitch]. Fully batched/jittable; <=1e-7 m residual in 10 iterations
    (the crude seed can be decimeters off, so convergence takes a few steps).
    Opt-in via the "T1-newton" robot registry entry.
    """
    dtype = p_foot_b.dtype
    active = jnp.asarray([0, 1, 3, 4])
    lam = 1e-6

    def body(q, _):
        p, _frames = forward_kinematics(q, leg)
        jac = contact_jacobian(q, leg)[:3, :]  # (3, 6)
        j4 = jac[:, active]  # (3, 4)
        r = p_foot_b - p
        m = j4 @ j4.T + lam * jnp.eye(3, dtype=dtype)
        # Closed-form 3x3 inverse: elementwise math, no batched LU call.
        dq4 = j4.T @ (linalg.inverse_3x3(m) @ r)
        q = q.at[active].add(dq4)
        return q, None

    q0 = analytical_ik(p_foot_b, leg)
    q, _ = jax.lax.scan(body, q0, None, length=iterations)
    return q


def hip_horizontal_location(leg: int, dtype=jnp.float32) -> jnp.ndarray:
    """CoG projection for the Raibert heuristic (`t1.py:81-90`)."""
    side = 1.0 if leg == 0 else -1.0
    return jnp.asarray([0.0625 - 0.014, side * 0.106, 0.0], dtype=dtype)
