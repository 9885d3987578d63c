"""SRBD model tests: affine structure and exact RK4 discretization."""

import jax.numpy as jnp
import numpy as np
import pytest

from biped_pympc_tpu.models import srbd


def _lin(dtype=jnp.float64):
    rng = np.random.default_rng(7)
    rpy = rng.uniform(-0.3, 0.3, 3)
    from biped_pympc_tpu.utils import maths

    r = np.asarray(
        maths.rot_z(jnp.asarray(rpy[2]))
        @ maths.rot_y(jnp.asarray(rpy[1]))
        @ maths.rot_x(jnp.asarray(rpy[0]))
    )
    i_body = np.diag([0.5413, 0.52, 0.0691])
    return srbd.SrbdLin(
        rot_body=jnp.asarray(r, dtype=dtype),
        inertia_world=jnp.asarray(r @ i_body @ r.T, dtype=dtype),
        body_pos=jnp.asarray([0.02, -0.01, 0.55], dtype=dtype),
        foot_pos=jnp.asarray([[0.1, 0.08, 0.0], [0.07, -0.09, 0.01]], dtype=dtype),
        mass=jnp.asarray(13.856, dtype=dtype),
        residual_lin_accel=jnp.asarray([0.1, -0.2, 0.05], dtype=dtype),
        residual_ang_accel=jnp.asarray([-0.03, 0.02, 0.01], dtype=dtype),
    )


def test_rhs_matches_hand_derivation():
    """xdot from the affine form vs a from-scratch NumPy evaluation of the
    reference equations (`srbd_centroidal_model.py:151-166`)."""
    lin = _lin()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(12)
    u = rng.standard_normal(12)

    r = np.asarray(lin.rot_body)
    iw = np.asarray(lin.inertia_world)
    fl, fr, ml, mr = u[0:3], u[3:6], u[6:9], u[9:12]
    pl = np.asarray(lin.foot_pos[0]) - np.asarray(lin.body_pos)
    pr = np.asarray(lin.foot_pos[1]) - np.asarray(lin.body_pos)

    for mode, rm in (("rt_omega", r.T), ("r_omega", r)):
        expected = np.concatenate(
            [
                rm @ x[6:9],
                x[9:12],
                np.linalg.solve(iw, np.cross(pl, fl) + np.cross(pr, fr) + ml + mr)
                + np.asarray(lin.residual_ang_accel),
                (fl + fr) / float(lin.mass)
                + np.array([0, 0, -srbd.GRAVITY])
                + np.asarray(lin.residual_lin_accel),
            ]
        )
        got = np.asarray(
            srbd.dynamics_rhs(lin, jnp.asarray(x), jnp.asarray(u), mode)
        )
        np.testing.assert_allclose(got, expected, atol=1e-12)


def test_closed_form_rk4_equals_generic_rk4():
    """Ad x + Bd u + cd must equal literal 4-stage RK4 (affine exactness)."""
    lin = _lin()
    dt = jnp.asarray(0.025)
    disc = srbd.discrete_dynamics(lin, dt)
    rng = np.random.default_rng(5)
    for _ in range(4):
        x = jnp.asarray(rng.standard_normal(12))
        u = jnp.asarray(rng.standard_normal(12))
        closed = disc.A @ x + disc.B @ u + disc.c
        generic = srbd.rk4_step_generic(lin, x, u, dt)
        np.testing.assert_allclose(np.asarray(closed), np.asarray(generic), atol=1e-12)


def test_nilpotency_shortcut_is_exact():
    """Ac^3 == 0 for the SRBD structure, so the quartic terms vanish."""
    lin = _lin()
    ac = np.asarray(srbd.continuous_dynamics(lin).A)
    assert np.abs(np.linalg.matrix_power(ac, 3)).max() == 0.0


def test_hover_equilibrium():
    """Weight-compensating forces with matching moments keep the body still."""
    lin = srbd.SrbdLin(
        rot_body=jnp.eye(3),
        inertia_world=jnp.asarray(np.diag([0.5413, 0.52, 0.0691])),
        body_pos=jnp.asarray([0.0, 0.0, 0.55]),
        foot_pos=jnp.asarray([[0.0, 0.05, 0.0], [0.0, -0.05, 0.0]]),
        mass=jnp.asarray(13.5),
        residual_lin_accel=jnp.zeros(3),
        residual_ang_accel=jnp.zeros(3),
    )
    w = 13.5 * srbd.GRAVITY / 2
    u = np.zeros(12)
    u[2] = u[5] = w
    # per-foot moments cancel the (p_f - p_b) x F torque
    u[6:9] = -np.cross(np.array([0.0, 0.05, -0.55]), u[0:3])
    u[9:12] = -np.cross(np.array([0.0, -0.05, -0.55]), u[3:6])
    x = np.zeros(12)
    x[5] = 0.55
    xdot = np.asarray(srbd.dynamics_rhs(lin, jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(xdot, 0.0, atol=1e-12)


def test_matrix_residual_zero_path_identical():
    """residual_A/B = None and explicit zeros give the SAME dynamics, and
    the None path is the exact pre-feature program (`set_srbd_residual`
    plumbing, reference `mpc_wrapper.py:66-67`)."""
    lin = _lin()
    base = srbd.discrete_dynamics(lin, jnp.asarray(0.025))
    z = jnp.zeros((12, 12), jnp.float64)
    with_zeros = srbd.discrete_dynamics(
        lin._replace(residual_A=z, residual_B=z), jnp.asarray(0.025)
    )
    np.testing.assert_array_equal(np.asarray(base.A), np.asarray(with_zeros.A))
    np.testing.assert_array_equal(np.asarray(base.B), np.asarray(with_zeros.B))
    np.testing.assert_array_equal(np.asarray(base.c), np.asarray(with_zeros.c))


def test_matrix_residual_enters_before_discretization():
    """With residuals Ra, Rb the continuous model is exactly (A+Ra, B+Rb, c)
    and RK4 discretization propagates the modified A (not A + dt*Ra-style
    post-hoc patching): closed form still equals the literal 4-stage RK4."""
    lin = _lin()
    rng = np.random.default_rng(11)
    ra = jnp.asarray(0.1 * rng.standard_normal((12, 12)))
    rb = jnp.asarray(0.1 * rng.standard_normal((12, 12)))
    lin_r = lin._replace(residual_A=ra, residual_B=rb)

    cont = srbd.continuous_dynamics(lin)
    cont_r = srbd.continuous_dynamics(lin_r)
    np.testing.assert_allclose(
        np.asarray(cont_r.A), np.asarray(cont.A + ra), atol=1e-15)
    np.testing.assert_allclose(
        np.asarray(cont_r.B), np.asarray(cont.B + rb), atol=1e-15)
    np.testing.assert_array_equal(np.asarray(cont_r.c), np.asarray(cont.c))

    # The residual A breaks nilpotency, so the discretization must carry the
    # full quartic series — pinned against the literal 4-stage integrator.
    dt = jnp.asarray(0.025)
    disc = srbd.discrete_dynamics(lin_r, dt)
    x = jnp.asarray(rng.standard_normal(12))
    u = jnp.asarray(rng.standard_normal(12))
    closed = disc.A @ x + disc.B @ u + disc.c
    generic = srbd.rk4_step_generic(lin_r, x, u, dt)
    np.testing.assert_allclose(
        np.asarray(closed), np.asarray(generic), atol=1e-12)


def test_mixed_dtype_leaves_no_future_warning():
    """f64 residual/parameter leaves into an f32 model must not rely on
    scatter promotion (jax FutureWarning, future hard error): the builder
    casts every SrbdLin leaf to the rot_body dtype."""
    import warnings

    lin64 = _lin(dtype=jnp.float64)
    lin_mixed = lin64._replace(rot_body=jnp.asarray(lin64.rot_body, jnp.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        dyn = srbd.discrete_dynamics(lin_mixed, jnp.float32(0.025))
    assert dyn.A.dtype == jnp.float32
    assert dyn.B.dtype == jnp.float32
    assert dyn.c.dtype == jnp.float32
    # And the cast is value-faithful: f32 build == f64 build downcast.
    import jax

    lin32 = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float32), lin64
    )
    dyn32 = srbd.discrete_dynamics(lin32, jnp.float32(0.025))
    np.testing.assert_allclose(
        np.asarray(dyn.A), np.asarray(dyn32.A), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(dyn.c), np.asarray(dyn32.c), rtol=1e-6, atol=1e-7
    )
