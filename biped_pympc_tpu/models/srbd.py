"""Single-rigid-body dynamics (SRBD) for bipedal convex MPC — pure JAX.

JAX re-derivation of the reference's CasADi symbolic model
(`/root/reference/biped_pympc/casadi/srbd_centroidal_model.py:123-166`) and its
RK4 discretization (`:101-121`). The key structural observation exploited here:
for a *fixed* linearization point (rotation, inertia, foot positions), the SRBD
dynamics are **affine** in (state, input):

    xdot = Ac @ x + Bc @ u + c

with state x = [rpy(3), p(3), omega_w(3), v_w(3)] and input
u = [F_L(3), F_R(3), M_L(3), M_R(3)]. Therefore RK4 with zero-order-hold input
has an exact closed form (Ac is nilpotent, Ac^3 == 0), and the reference's
CasADi-jacobian linearization of the RK4 defect is reproduced analytically —
no symbolic layer, no codegen.

Euler-rate convention (`euler_rate_mode`):
  * "rt_omega" (default): rpy_dot = R^T @ omega_w. This is what the reference's
    shipped CUDA path actually computes: the torch side row-major-flattens
    R_body while the generated kernel reads it column-major
    (`mpc_controller_cusadi.py:58` vs CasADi's column-major input layout), so
    the kernel sees R^T. R^T @ omega_w = omega_body, the standard small-angle
    euler-rate approximation used in MIT-Cheetah-style convex MPC.
  * "r_omega": rpy_dot = R @ omega_w, the literal CasADi source semantics
    (`srbd_centroidal_model.py:153`), matching the reference's CPU backends.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Closed-form 3x3 inverse: pure elementwise math instead of the generic
# batched LU that `jnp.linalg.inv` lowers to.
from biped_pympc_tpu.ops.linalg import inverse_3x3 as _inv3

GRAVITY = 9.81


class SrbdLin(NamedTuple):
    """Linearization point / parameters of the affine SRBD model (single env).

    Mirrors the parameter vector of the reference qp_former
    (`srbd_constraints.py:34-47`), plus the learned dynamics-residual
    matrices the reference *declares* but never implements
    (`mpc_wrapper.py:66-67` raises NotImplementedError): `residual_A` /
    `residual_B` are added to the continuous-time A / B blocks BEFORE
    discretization, so an RL policy can inject state- and input-dependent
    model corrections (not just the constant acceleration residuals).
    `None` (the default) keeps the exact unmodified dynamics path — the
    residual-free program is structurally identical to one without the
    feature.
    """

    rot_body: jnp.ndarray  # (3, 3) body-to-world rotation R
    inertia_world: jnp.ndarray  # (3, 3) world-frame inertia (R I_b R^T)
    body_pos: jnp.ndarray  # (3,)
    foot_pos: jnp.ndarray  # (2, 3) [left, right] world-frame foot positions
    mass: jnp.ndarray  # () scalar
    residual_lin_accel: jnp.ndarray  # (3,)
    residual_ang_accel: jnp.ndarray  # (3,)
    residual_A: jnp.ndarray | None = None  # (12, 12) added to continuous A
    residual_B: jnp.ndarray | None = None  # (12, 12) added to continuous B


class AffineDynamics(NamedTuple):
    """xdot = A @ x + B @ u + c (continuous) or x+ = A x + B u + c (discrete)."""

    A: jnp.ndarray  # (12, 12)
    B: jnp.ndarray  # (12, 12)
    c: jnp.ndarray  # (12,)


def _skew(v):
    x, y, z = v[0], v[1], v[2]
    o = jnp.zeros_like(x)
    return jnp.array([[o, -z, y], [z, o, -x], [-y, x, o]])




def continuous_dynamics(lin: SrbdLin, euler_rate_mode: str = "rt_omega") -> AffineDynamics:
    """Affine continuous-time SRBD at the linearization point.

    Rows (reference `srbd_centroidal_model.py:151-166`):
      rpy_dot   = Rm @ omega_w                  (Rm = R or R^T per mode)
      p_dot     = v_w
      omega_dot = I_w^{-1} (skew(p_L - p_b) F_L + skew(p_R - p_b) F_R
                            + M_L + M_R) + res_ang
      v_dot     = (F_L + F_R)/m + g + res_lin
    """
    dtype = lin.rot_body.dtype
    # Dtype hygiene: the model dtype is set by rot_body; callers routinely
    # hand mixed-precision leaves (e.g. f64 residuals under x64 tests). Cast
    # every leaf here so assembly never relies on scatter promotion (which
    # is a FutureWarning today and a hard error in future jax).
    cast = lambda v: jnp.asarray(v, dtype)
    inertia_world = cast(lin.inertia_world)
    body_pos = cast(lin.body_pos)
    foot_pos = cast(lin.foot_pos)
    mass = cast(lin.mass)
    res_ang = cast(lin.residual_ang_accel)
    res_lin = cast(lin.residual_lin_accel)

    rm = lin.rot_body.T if euler_rate_mode == "rt_omega" else lin.rot_body
    inertia_inv = _inv3(inertia_world)

    A = jnp.zeros((12, 12), dtype=dtype)
    A = A.at[0:3, 6:9].set(rm)
    A = A.at[3:6, 9:12].set(jnp.eye(3, dtype=dtype))

    B = jnp.zeros((12, 12), dtype=dtype)
    B = B.at[6:9, 0:3].set(inertia_inv @ _skew(foot_pos[0] - body_pos))
    B = B.at[6:9, 3:6].set(inertia_inv @ _skew(foot_pos[1] - body_pos))
    B = B.at[6:9, 6:9].set(inertia_inv)
    B = B.at[6:9, 9:12].set(inertia_inv)
    B = B.at[9:12, 0:3].set(jnp.eye(3, dtype=dtype) / mass)
    B = B.at[9:12, 3:6].set(jnp.eye(3, dtype=dtype) / mass)

    c = jnp.zeros((12,), dtype=dtype)
    c = c.at[6:9].set(res_ang)
    c = c.at[9:12].set(
        jnp.array([0.0, 0.0, -GRAVITY], dtype=dtype) + res_lin
    )
    # Learned dynamics-residual matrices (the reference's unimplemented
    # `set_srbd_residual` promise, `mpc_wrapper.py:66-67`): applied to the
    # continuous-time model so RK4 discretization propagates them exactly.
    if lin.residual_A is not None:
        A = A + cast(lin.residual_A)
    if lin.residual_B is not None:
        B = B + cast(lin.residual_B)
    return AffineDynamics(A, B, c)


def discretize_rk4(cont: AffineDynamics, dt: jnp.ndarray) -> AffineDynamics:
    """Exact RK4 discretization of an affine system with ZOH input.

    For xdot = A x + B u + c, classic RK4 over a step dt gives exactly
        Ad = I + dt A + (dt A)^2/2 + (dt A)^3/6 + (dt A)^4/24
        M  = dt (I + dt A/2 + (dt A)^2/6 + (dt A)^3/24)
        Bd = M B,  cd = M c
    which reproduces the reference's `rk4_integrator`
    (`srbd_centroidal_model.py:101-121`) and hence the CasADi-jacobian
    linearization of the dynamics defect in `srbd_constraints.py:120-126`.
    """
    A, B, c = cont
    n = A.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    dA = dt * A
    dA2 = dA @ dA
    dA3 = dA2 @ dA
    dA4 = dA3 @ dA
    Ad = eye + dA + dA2 / 2.0 + dA3 / 6.0 + dA4 / 24.0
    M = dt * (eye + dA / 2.0 + dA2 / 6.0 + dA3 / 24.0)
    return AffineDynamics(Ad, M @ B, M @ c)


def discrete_dynamics(
    lin: SrbdLin, dt: jnp.ndarray, euler_rate_mode: str = "rt_omega"
) -> AffineDynamics:
    """Convenience: continuous model at `lin`, discretized with RK4 at `dt`."""
    return discretize_rk4(continuous_dynamics(lin, euler_rate_mode), dt)


def dynamics_rhs(lin: SrbdLin, x: jnp.ndarray, u: jnp.ndarray,
                 euler_rate_mode: str = "rt_omega") -> jnp.ndarray:
    """Evaluate xdot at (x, u) — used by tests and rollouts."""
    d = continuous_dynamics(lin, euler_rate_mode)
    return d.A @ x + d.B @ u + d.c


def rk4_step_generic(lin: SrbdLin, x: jnp.ndarray, u: jnp.ndarray, dt: jnp.ndarray,
                     euler_rate_mode: str = "rt_omega") -> jnp.ndarray:
    """Literal 4-stage RK4 (test oracle for `discretize_rk4`).

    Mirrors `srbd_centroidal_model.py:110-115`.
    """
    d = continuous_dynamics(lin, euler_rate_mode)  # affine: build A,B,c once
    f = lambda xx: d.A @ xx + d.B @ u + d.c
    k1 = f(x)
    k2 = f(x + dt / 2 * k1)
    k3 = f(x + dt / 2 * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
