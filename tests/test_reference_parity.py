"""LIVE differential parity vs the reference's runnable torch components.

Instead of hand-captured golden literals, these tests import the
reference's `biped_pympc` package directly (torch CPU, from `REF_ROOT`)
and compare our JAX control stack against the actually-running reference
program over randomized states — math utils, HECTOR kinematics, gait
generator, estimator, Raibert/Bezier swing machinery, leg-controller torque
assembly, and a ~500-tick lockstep rollout of the full `BipedController`
orchestration with an identical mock solver injected on both sides.

The reference's solver stack (CasADi artifacts, CUDA kernels) is NOT
runnable here; `casadi` and `biped_pympc.cusadi` are stubbed at import so
the pure-torch modules load (`t1.py:9` pulls them transitively). The QP/
solver side has its own oracle chain (golden NumPy PDIPM re-derivation +
independent C++ solver, `tests/test_pdipm.py`, `tests/test_native.py`).

Intentional deviations (ledger also in PARITY.md):
  * HECTOR right-leg contact Jacobian: the reference reuses LEFT-leg
    transforms (`hector.py:202-206`); ours is correct (finite-difference
    verified against the reference's own FK). Asserted as an EXPECTED delta
    at nonzero hip-yaw, exact agreement at zero hip-yaw.
"""

import importlib
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow

torch = pytest.importorskip("torch")

REF_ROOT = "/root/reference"


@pytest.fixture(scope="module")
def ref():
    """Import the reference package with casadi/cusadi stubbed."""
    if REF_ROOT not in sys.path:
        sys.path.insert(0, REF_ROOT)
    if "casadi" not in sys.modules:
        class _StubModule(types.ModuleType):
            def __getattr__(self, name):  # cs.Function, cs.DM, ... (t1.py)
                return type(name, (), {})
        sys.modules["casadi"] = _StubModule("casadi")
    if "biped_pympc.cusadi" not in sys.modules:
        cus = types.ModuleType("biped_pympc.cusadi")
        cus.CASADI_FUNCTION_DIR = "/nonexistent"
        cus.CUSADI_FUNCTION_DIR = "/nonexistent"
        sys.modules["biped_pympc.cusadi"] = cus

    names = dict(
        math="biped_pympc.utils.math_utils",
        gait="biped_pympc.core.gait.gait_generator",
        hector="biped_pympc.core.robot.hector",
        est="biped_pympc.controllers.state_estimator",
        swing="biped_pympc.controllers.swing_leg_controller",
        traj="biped_pympc.controllers.swing_leg_trajectory",
        legs="biped_pympc.controllers.leg_controller",
        data="biped_pympc.core.data.robot_data",
        cfg="biped_pympc.configuration.configuration",
        bc="biped_pympc.biped_controller",
        base="biped_pympc.convex_mpc.base_controller",
    )
    ns = types.SimpleNamespace()
    for k, m in names.items():
        setattr(ns, k, importlib.import_module(m))
    return ns


def _t(x):
    # COPY into torch: the reference mutates tensors in place, and
    # torch.asarray would alias the numpy/JAX buffer (flaky cross-side
    # contamination, observed).
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _n(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Math utils (`utils/math_utils.py:3-177`)
# ---------------------------------------------------------------------------

def test_math_utils_live_parity(ref):
    from biped_pympc_tpu.utils import maths

    rng = np.random.default_rng(0)
    n = 256
    ang = rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(np.float32)
    for ref_fn, our_fn in ((ref.math.rot_x, maths.rot_x),
                           (ref.math.rot_y, maths.rot_y),
                           (ref.math.rot_z, maths.rot_z)):
        want = _n(ref_fn(_t(ang)))
        got = _n(jax.vmap(our_fn)(jnp.asarray(ang)))
        np.testing.assert_allclose(got, want, atol=2e-6)

    quat = rng.standard_normal((n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    np.testing.assert_allclose(
        _n(jax.vmap(maths.quat_to_rotmat)(jnp.asarray(quat))),
        _n(ref.math.quaternion_to_rotation_matrix(_t(quat))), atol=3e-6)
    np.testing.assert_allclose(
        _n(jax.vmap(maths.quat_to_euler)(jnp.asarray(quat))),
        _n(ref.math.quat_to_euler(_t(quat))), atol=3e-6)

    v = rng.standard_normal((n, 3)).astype(np.float32)
    sk_ref = _n(ref.math.skew_symmetric(_t(v)))
    sk_our = _n(jax.vmap(maths.skew)(jnp.asarray(v)))
    np.testing.assert_allclose(sk_our, sk_ref, atol=0)
    # Reference unskew consumes (B, T, 3, 3) (`math_utils.py:169-177`).
    np.testing.assert_allclose(
        _n(jax.vmap(maths.unskew)(jnp.asarray(sk_ref))),
        _n(ref.math.unskew_symmetric(_t(sk_ref[:, None])))[:, 0], atol=0)


# ---------------------------------------------------------------------------
# HECTOR kinematics (`core/robot/hector.py:54-276`)
# ---------------------------------------------------------------------------

def _hector_q(rng, n):
    """Plausible joint angles [yaw, roll, pitch, knee, ankle]."""
    lo = np.array([-0.4, -0.4, -0.9, -1.8, -0.9], np.float32)
    hi = np.array([0.4, 0.4, 0.9, -0.1, 0.9], np.float32)
    return rng.uniform(lo, hi, (n, 5)).astype(np.float32)


def test_hector_fk_ik_live_parity(ref):
    from biped_pympc_tpu.models import hector as ours

    n = 128
    rng = np.random.default_rng(1)
    q = _hector_q(rng, n)
    robot = ref.hector.HECTOR(n, torch.device("cpu"))
    for leg in (0, 1):
        robot.forward_kinematics(_t(q), leg)
        want_p = _n(robot.get_p0e(leg))
        got_p = _n(jax.vmap(lambda qq: ours.foot_position(qq, leg))(
            jnp.asarray(q)))
        np.testing.assert_allclose(got_p, want_p, atol=2e-6,
                                   err_msg=f"FK leg {leg}")
        # IK round trip on reachable targets (the reference's own FK output)
        want_ik = _n(robot.analytical_IK(_t(want_p), leg))
        got_ik = _n(jax.vmap(lambda pp: ours.analytical_ik(pp, leg))(
            jnp.asarray(want_p)))
        np.testing.assert_allclose(got_ik, want_ik, atol=5e-5,
                                   err_msg=f"IK leg {leg}")


def test_hector_jacobian_live_parity_and_reference_bug(ref):
    """Left leg exact; right leg = the documented reference bug.

    `hector.py:202-206` builds the right-leg Jacobian's joint z-axes from
    the LEFT leg's transforms (`T0i_left`) — the rotation chains coincide
    when both legs hold IDENTICAL joint angles (measured: ref J == FD then),
    so the bug is invisible in symmetric-pose smoke tests, but any real
    walking state has q_left != q_right and the reference's right J is then
    built from the wrong leg's axes. Ours matches finite differences of the
    REFERENCE'S OWN right-leg FK in that realistic asymmetric case; the
    reference's right J does not."""
    from biped_pympc_tpu.models import hector as ours

    n = 64
    rng = np.random.default_rng(2)
    q = _hector_q(rng, n)
    q_left = _hector_q(rng, n)  # independent left-leg pose (walking state)
    robot = ref.hector.HECTOR(n, torch.device("cpu"))

    robot.forward_kinematics(_t(q_left), 0)
    robot.forward_kinematics(_t(q), 1)

    # Left leg: live agreement.
    want_jl = _n(robot.contact_jacobian(0))
    got_jl = _n(jax.vmap(lambda qq: ours.contact_jacobian(qq, 0))(
        jnp.asarray(q_left)))
    np.testing.assert_allclose(got_jl, want_jl, atol=5e-6)

    # Right leg: finite-difference the reference's own FK as ground truth.
    def ref_fk_right(qq):
        robot.forward_kinematics(_t(qq), 1)
        return _n(robot.get_p0e(1)).copy()

    eps = 1e-3
    fd = np.zeros((n, 3, 5), np.float64)
    for j in range(5):
        qp = q.copy(); qp[:, j] += eps
        qm = q.copy(); qm[:, j] -= eps
        fd[:, :, j] = (ref_fk_right(qp) - ref_fk_right(qm)) / (2 * eps)

    robot.forward_kinematics(_t(q), 1)
    ref_jr = _n(robot.contact_jacobian(1))[:, :3]
    our_jr = _n(jax.vmap(lambda qq: ours.contact_jacobian(qq, 1))(
        jnp.asarray(q)))[:, :3]
    our_err = np.abs(our_jr - fd).max()
    ref_err = np.abs(ref_jr - fd).max()
    assert our_err < 5e-3, f"our right-leg J vs FD: {our_err}"
    assert ref_err > 10 * our_err, (
        f"expected the reference right-leg J bug (ref {ref_err} vs ours "
        f"{our_err}); has the reference been fixed?")


# ---------------------------------------------------------------------------
# Gait generator (`core/gait/gait_generator.py:101-252`)
# ---------------------------------------------------------------------------

def test_gait_live_parity_randomized(ref):
    """Random (dsp, ssp, dt_mpc, phase) over the reference's supported
    domain: dsp SYMMETRIC per its own precondition ("dsp should be
    symmetric for both feet", `gait_generator.py:124,135`) — with
    asymmetric dsp=[0,k] the reference divides by the zero-width window
    and emits inf (measured), while our masks stay finite."""
    from biped_pympc_tpu.control import gait as ours

    rng = np.random.default_rng(3)
    n = 400
    dsp = np.repeat(rng.integers(0, 5, (n, 1)), 2, axis=1).astype(np.int32)
    ssp = rng.integers(1, 7, (n, 2)).astype(np.int32)
    dt_mpc = rng.uniform(0.015, 0.05, n).astype(np.float32)
    phase = rng.uniform(0, 1, n).astype(np.float32)
    horizon = 10

    gg = ref.gait.GaitGenerator(
        batch_size=n, mpc_horizon=horizon, dt=0.001,
        dt_mpc=_t(dt_mpc),
        dsp_durations=torch.tensor(dsp), ssp_durations=torch.tensor(ssp))
    gg.gait_phase = _t(phase)

    params = ours.GaitParams(dsp_steps=jnp.asarray(dsp),
                             ssp_steps=jnp.asarray(ssp))
    ph = jnp.asarray(phase)

    np.testing.assert_allclose(
        _n(jax.vmap(ours.contact_sub_phase)(ph, params)),
        _n(gg.get_contact_sub_phase()), atol=1e-6)
    np.testing.assert_allclose(
        _n(jax.vmap(ours.swing_sub_phase)(ph, params)),
        _n(gg.get_swing_sub_phase()), atol=1e-6)
    np.testing.assert_array_equal(
        _n(jax.vmap(lambda p, g: ours.mpc_contact_table(p, g, horizon))(
            ph, params)),
        _n(gg.mpc_gait))

    # Phase advance over 100 control ticks, including wrap behavior.
    for _ in range(100):
        gg.update_phase()
        ph = jax.vmap(lambda p, g, d: ours.advance_phase(p, g, 0.001, d))(
            ph, params, jnp.asarray(dt_mpc))
    np.testing.assert_allclose(_n(ph), _n(gg.gait_phase), atol=2e-5)

    # Durations in seconds (`gait_generator.py:74-76`).
    np.testing.assert_allclose(
        _n(jax.vmap(ours.swing_duration_sec)(params, jnp.asarray(dt_mpc))),
        _n(gg.swing_durations_sec), atol=1e-7)


# ---------------------------------------------------------------------------
# State estimator (`controllers/state_estimator.py:22-45`)
# ---------------------------------------------------------------------------

def test_estimator_live_parity(ref):
    from biped_pympc_tpu.control import estimator as ours

    rng = np.random.default_rng(4)
    n = 200
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    quat = rng.standard_normal((n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    v_b = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    w_b = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    foot_b = rng.uniform(-0.6, 0.6, (n, 2, 3)).astype(np.float32)

    se = ref.est.StateEstimator(num_legs=2, batch_size=n)
    se.set_body_state(_t(pos), _t(quat), _t(v_b), _t(w_b))
    se.update_foot_position(_t(foot_b.reshape(n, 6)))

    est = jax.vmap(ours.estimate)(
        jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(v_b),
        jnp.asarray(w_b), jnp.asarray(foot_b))

    np.testing.assert_allclose(_n(est.root_euler), _n(se.data.root_euler),
                               atol=3e-6)
    np.testing.assert_allclose(_n(est.rotation_body),
                               _n(se.data.rotation_body), atol=3e-6)
    np.testing.assert_allclose(_n(est.root_velocity_w),
                               _n(se.data.root_velocity_w), atol=5e-6)
    np.testing.assert_allclose(_n(est.root_angular_velocity_w),
                               _n(se.data.root_angular_velocity_w), atol=5e-6)
    np.testing.assert_allclose(_n(est.foot_position_w),
                               _n(se.data.foot_position), atol=5e-6)


# ---------------------------------------------------------------------------
# Raibert placement + swing curves
# (`swing_leg_controller.py:9-61`, `swing_leg_trajectory.py:97-162`)
# ---------------------------------------------------------------------------

def test_raibert_placement_live_parity(ref):
    from biped_pympc_tpu.control import swing as ours
    from biped_pympc_tpu.utils import maths

    rng = np.random.default_rng(5)
    n = 200
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    rot = _n(jax.vmap(maths.rot_z)(jnp.asarray(yaw)))
    v_w = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v_des_w = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    t_rem = rng.uniform(0.01, 0.3, (n, 2)).astype(np.float32)
    t_dur = rng.uniform(0.05, 0.3, (n, 2)).astype(np.float32)
    hip = np.stack([
        np.tile([-0.0135, 0.098, 0.0], (n, 1)),
        np.tile([-0.0135, -0.098, 0.0], (n, 1)),
    ], axis=1).astype(np.float32)

    want = _n(ref.swing.compute_raibert_heuristic_placement(
        _t(pos), _t(rot), _t(v_w), _t(v_des_w), _t(t_dur), _t(t_rem),
        0.3, 0.3, 0.03, 0.03, _t(hip)))
    got = _n(jax.vmap(
        lambda a, b, c, d, e, h: ours.raibert_placement(a, b, c, d, e, h)
    )(jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(v_w),
      jnp.asarray(v_des_w), jnp.asarray(t_rem), jnp.asarray(hip)))
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_swing_curves_live_parity(ref):
    from biped_pympc_tpu.control import swing as ours

    rng = np.random.default_rng(6)
    n = 200
    phase = rng.uniform(0, 1, n).astype(np.float32)
    t_sw = rng.uniform(0.05, 0.4, n).astype(np.float32)
    p0 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pf = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    height = rng.uniform(0.05, 0.2, n).astype(np.float32)
    cp1 = rng.uniform(0.2, 0.45, n).astype(np.float32)
    cp2 = rng.uniform(0.55, 0.8, n).astype(np.float32)

    want_p, want_v = ref.traj.SwingLegTrajectory.cubic_bezier_trajectory(
        _t(phase), _t(t_sw), _t(p0), _t(pf), _t(height), _t(cp1), _t(cp2))
    got_p, got_v = jax.vmap(ours.cubic_bezier)(
        jnp.asarray(phase), jnp.asarray(t_sw), jnp.asarray(p0),
        jnp.asarray(pf), jnp.asarray(height), jnp.asarray(cp1),
        jnp.asarray(cp2))
    np.testing.assert_allclose(_n(got_p), _n(want_p), atol=5e-6)
    np.testing.assert_allclose(_n(got_v), _n(want_v), atol=5e-5)

    want_p, want_v = ref.traj.SwingLegTrajectory.cycloid_trajectory(
        _t(phase), _t(t_sw), _t(p0), _t(pf), _t(height))
    got_p, got_v = jax.vmap(ours.cycloid)(
        jnp.asarray(phase), jnp.asarray(t_sw), jnp.asarray(p0),
        jnp.asarray(pf), jnp.asarray(height))
    np.testing.assert_allclose(_n(got_p), _n(want_p), atol=5e-6)
    np.testing.assert_allclose(_n(got_v), _n(want_v), atol=5e-5)


# ---------------------------------------------------------------------------
# Leg controller torque assembly (`controllers/leg_controller.py:40-119`)
# ---------------------------------------------------------------------------

def test_leg_controller_live_parity(ref):
    from biped_pympc_tpu.control import legs as ours_legs
    from biped_pympc_tpu.models.robot import HECTOR as OUR_HECTOR

    rng = np.random.default_rng(7)
    n = 64
    q = np.concatenate([_hector_q(rng, n), _hector_q(rng, n)], axis=1)
    qd = rng.uniform(-3, 3, (n, 10)).astype(np.float32)
    tau = rng.uniform(-10, 10, (n, 10)).astype(np.float32)
    # Random mixed contact/swing states.
    contact_phase = np.where(rng.random((n, 2)) < 0.5, -1.0,
                             rng.random((n, 2))).astype(np.float32)
    swing_phase = np.where(contact_phase == -1.0,
                           rng.random((n, 2)), -1.0).astype(np.float32)
    wrench = rng.uniform(-80, 80, (n, 2, 6)).astype(np.float32)
    p_des = rng.uniform(-0.4, 0.1, (n, 2, 3)).astype(np.float32)
    p_des[:, :, 2] -= 0.3
    v_des = rng.uniform(-1, 1, (n, 2, 3)).astype(np.float32)

    lc = ref.legs.LegController(n, 2, torch.device("cpu"), "HECTOR")
    lc.update_gait_data(_t(contact_phase), _t(swing_phase))
    lc.update_data(_t(q), _t(qd), _t(tau))
    lc.command.feedfowardforce = _t(wrench)
    lc.command.pDes = _t(p_des)
    lc.command.vDes = _t(v_des)
    lc.update_command()

    data = jax.vmap(
        lambda *a: ours_legs.update_data(OUR_HECTOR, *a)
    )(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau),
      jnp.asarray(contact_phase), jnp.asarray(swing_phase))
    cmd = jax.vmap(lambda _: ours_legs.init_command(5))(jnp.arange(n))
    cmd = cmd._replace(wrench_ff=jnp.asarray(wrench),
                       p_des=jnp.asarray(p_des), v_des=jnp.asarray(v_des))
    cmd = jax.vmap(lambda d, c: ours_legs.update_command(OUR_HECTOR, d, c))(
        data, cmd)

    np.testing.assert_allclose(_n(data.p), _n(lc.data.p), atol=5e-6)
    # Jacobian-derived right-leg quantities (v = Jv qd, tau = J^T w,
    # qdDes = Jv^T vDes) inherit the reference's right-leg Jacobian bug
    # (asymmetric q here), so those comparisons are left-leg only.
    np.testing.assert_allclose(_n(data.v)[:, 0], _n(lc.data.v)[:, 0],
                               atol=2e-5)
    np.testing.assert_allclose(_n(data.jac)[:, 0], _n(lc.data.J)[:, 0],
                               atol=5e-6)

    np.testing.assert_allclose(_n(cmd.q_des), _n(lc.command.qDes), atol=1e-4)
    # Feed-forward tau = J^T w (stance-gated): exact on the left leg.
    np.testing.assert_allclose(_n(cmd.tau_ff)[:, 0],
                               _n(lc.command.tau)[:, 0], atol=2e-4)
    # qdDes = Jv^T vDes with yaw/ankle zeroed: left exact.
    np.testing.assert_allclose(_n(cmd.qd_des)[:, 0],
                               _n(lc.command.qdDes)[:, 0], atol=2e-5)
    # PD gains incl. the stance Kp zeroing quirk (`leg_controller.py:117-118`).
    np.testing.assert_allclose(_n(cmd.kp), _n(lc.command.kpjoint), atol=0)
    np.testing.assert_allclose(_n(cmd.kd), _n(lc.command.kdjoint), atol=0)


# ---------------------------------------------------------------------------
# Lockstep rollout: full BipedController orchestration, mock solver on both
# sides (`biped_controller.py:97-179` vs `control/controller.py`)
# ---------------------------------------------------------------------------

def test_lockstep_rollout_parity(ref):
    """500-tick lockstep of the reference `BipedController` vs our
    `BipedControllerCore` on a prescribed observation schedule, with an
    IDENTICAL mock solver injected on both sides (wrench = fixed linear map
    of the stage-0 reference-tracking error, post-processed exactly like the
    cusadi backend, `mpc_controller_cusadi.py:186-203`). Covers every
    cross-tick latch: gait phase accumulation, MPC first_run /
    world_position_desired / yaw_desired knots, swing first_swing + p0
    capture, and the full leg-command chain."""
    import functools
    import jax
    import jax.numpy as jnp
    from biped_pympc_tpu.config import ControllerConf as OurCC, MPCConf as OurMC
    from biped_pympc_tpu.control import mpc as our_mpc
    from biped_pympc_tpu.control.controller import BipedControllerCore

    B, ticks, dof, horizon, decim = 8, 500, 5, 10, 10
    dt = 0.001
    rng = np.random.default_rng(10)
    W = (0.3 * rng.standard_normal((12, 12))).astype(np.float32)
    Wt = torch.tensor(W)

    # --- reference side: inject the mock solver module ------------------
    mock_mod = types.ModuleType("biped_pympc.convex_mpc.mpc_controller_cusadi")

    class MPCControllerCusadi(ref.base.BaseMPCController):
        def init_solver(self):
            pass

        def run(self):
            self.compute_knot_points()
            self.compute_horizon_state()
            self.set_initial_state()
            self.compute_reference_trajectory()
            err = self.x0 - self.x_ref[:, 0, :]
            u = err @ Wt.T  # (B, 12) world [F_L, F_R, M_L, M_R]
            left_grf, right_grf = u[:, :3], u[:, 3:6]
            left_grm, right_grm = u[:, 6:9].clone(), u[:, 9:12].clone()
            left_grm[:, 0] = 0.0
            right_grm[:, 0] = 0.0
            R = self.state_estimate_data.rotation_body
            tb = lambda v: (R.transpose(1, 2) @ v.unsqueeze(-1)).squeeze(-1)
            foot_wrench = torch.cat(
                [-tb(left_grf), -tb(left_grm), -tb(right_grf), -tb(right_grm)],
                dim=1)
            return foot_wrench, torch.zeros(self.num_envs)

    mock_mod.MPCControllerCusadi = MPCControllerCusadi
    sys.modules["biped_pympc.convex_mpc.mpc_controller_cusadi"] = mock_mod
    try:
        bc = ref.bc.BipedController(
            ref.cfg.ControllerConf(), ref.cfg.MPCConf(solver="cusadi"),
            num_envs=B, num_legs=2, device=torch.device("cpu"), gait_id=2)
    finally:
        del sys.modules["biped_pympc.convex_mpc.mpc_controller_cusadi"]

    # --- our side: same mock spliced around the same machinery ----------
    core = BipedControllerCore(
        OurCC(), OurMC(solver="ric_aug", verbose=False), gait_id=2)
    state = core.init_state(B)
    Wj = jnp.asarray(W)

    @jax.jit
    def our_mock_mpc(state):
        new_mem, x_ref = jax.vmap(
            lambda mem, est, des, dtm: our_mpc.reference_trajectory(
                mem, est, des, dtm, horizon, decim * dt)
        )(state.mpc_mem, state.est, state.des, state.dt_mpc)
        est = state.est
        x0 = jnp.concatenate(
            [est.root_euler, est.root_position,
             est.root_angular_velocity_w, est.root_velocity_w], axis=1)
        u = (x0 - x_ref[:, 0, :]) @ Wj.T
        grf = u.reshape(B, 4, 3)
        grm = grf[:, 2:].at[:, :, 0].set(0.0)
        rot = est.rotation_body
        f_b = jnp.einsum("bji,bkj->bki", rot, grf[:, :2])
        m_b = jnp.einsum("bji,bkj->bki", rot, grm)
        wrench = jnp.concatenate([-f_b, -m_b], axis=2)  # (B, 2, 6)
        cmd = state.leg_cmd._replace(wrench_ff=wrench)
        return state._replace(mpc_mem=new_mem, leg_cmd=cmd, x_ref=x_ref)

    # --- prescribed inputs ----------------------------------------------
    twist = np.zeros((B, 3), np.float32)
    twist[:, 0] = np.linspace(-0.2, 0.4, B)  # env 2-3 near-stationary
    twist[:, 1] = np.linspace(-0.1, 0.1, B)
    twist[:, 2] = np.linspace(-0.2, 0.2, B)
    height = np.full(B, 0.55, np.float32)
    phases = np.linspace(0, 2 * np.pi, B, endpoint=False)

    def obs_at(k):
        t = k * dt
        pos = np.stack([
            0.1 * np.sin(0.5 * t + phases), 0.05 * np.sin(0.3 * t + phases),
            0.55 + 0.02 * np.sin(t + phases)], axis=1)
        rpy = np.stack([
            0.05 * np.sin(0.7 * t + phases), 0.06 * np.cos(0.9 * t + phases),
            0.3 * np.sin(0.2 * t + phases)], axis=1)
        cr, sr = np.cos(rpy[:, 0] / 2), np.sin(rpy[:, 0] / 2)
        cp, sp = np.cos(rpy[:, 1] / 2), np.sin(rpy[:, 1] / 2)
        cy, sy = np.cos(rpy[:, 2] / 2), np.sin(rpy[:, 2] / 2)
        quat = np.stack([
            cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], axis=1)
        v_b = np.stack([0.2 * np.sin(t + phases), 0.1 * np.cos(t + phases),
                        0.05 * np.sin(2 * t + phases)], axis=1)
        w_b = np.stack([0.3 * np.sin(t + phases), 0.2 * np.cos(t + phases),
                        0.4 * np.sin(0.5 * t + phases)], axis=1)
        base_q = np.array([0.0, 0.0, 0.45, -0.9, 0.45], np.float32)
        qs = base_q[None, None] + 0.2 * np.sin(
            t + phases[:, None, None] + np.array([[0.0], [np.pi]]))
        q = qs.reshape(B, 2 * dof)
        qd = 0.5 * np.cos(t + phases[:, None]) * np.ones((B, 2 * dof))
        tau = np.zeros((B, 2 * dof))
        return (pos.astype(np.float32), quat.astype(np.float32),
                v_b.astype(np.float32), w_b.astype(np.float32),
                q.astype(np.float32), qd.astype(np.float32),
                tau.astype(np.float32))

    bc.set_desired_state(_t(twist), _t(height))
    state = core.set_command(state, jnp.asarray(twist), jnp.asarray(height))

    def compare(k):
        np.testing.assert_allclose(
            _n(state.gait_phase), _n(bc.gait_generator.gait_phase),
            atol=2e-5, err_msg=f"gait phase @ tick {k}")
        np.testing.assert_allclose(
            _n(state.contact_phase), _n(bc.contact_phase), atol=3e-5,
            err_msg=f"contact phase @ tick {k}")
        np.testing.assert_allclose(
            _n(state.swing_phase), _n(bc.swing_phase), atol=3e-5,
            err_msg=f"swing phase @ tick {k}")
        np.testing.assert_allclose(
            _n(state.mpc_mem.world_position_desired),
            _n(bc.mpc_controller.world_position_desired), atol=1e-4,
            err_msg=f"wpd knot @ tick {k}")
        np.testing.assert_allclose(
            _n(state.mpc_mem.yaw_desired), _n(bc.mpc_controller.yaw_desired),
            atol=1e-4, err_msg=f"yaw knot @ tick {k}")
        np.testing.assert_allclose(
            _n(state.x_ref), _n(bc.mpc_controller.x_ref), atol=2e-4,
            err_msg=f"x_ref @ tick {k}")
        np.testing.assert_allclose(
            _n(state.leg_cmd.wrench_ff), _n(bc.leg_controller.command.feedfowardforce),
            atol=2e-4, err_msg=f"wrench @ tick {k}")
        np.testing.assert_allclose(
            _n(state.leg_data.p), _n(bc.leg_controller.data.p), atol=1e-5,
            err_msg=f"foot p @ tick {k}")
        np.testing.assert_allclose(
            _n(state.swing_state.foot_placement_w),
            _n(bc.swing_leg_controller.foot_placement), atol=1e-4,
            err_msg=f"raibert placement @ tick {k}")
        np.testing.assert_allclose(
            _n(state.swing_state.p0), _n(bc.swing_leg_controller.p0),
            atol=1e-4, err_msg=f"swing p0 @ tick {k}")
        # pDes/vDes: SWINGING legs only. For stance legs the reference
        # evaluates the Bezier at the raw sub-phase -1 (an out-of-domain
        # extrapolation, `swing_leg_controller.py:245-249`) while we clamp
        # the phase to [0, 1]; both values are masked out of the torque
        # path (`leg_controller.py:104-117`), so only the swing values are
        # behavior. Ledgered in PARITY.md.
        sw_mask = _n(state.swing_phase) >= 0
        np.testing.assert_allclose(
            _n(state.leg_cmd.p_des)[sw_mask],
            _n(bc.leg_controller.command.pDes)[sw_mask],
            atol=1e-4, err_msg=f"pDes @ tick {k}")
        np.testing.assert_allclose(
            _n(state.leg_cmd.v_des)[sw_mask],
            _n(bc.leg_controller.command.vDes)[sw_mask],
            atol=2e-3, err_msg=f"vDes @ tick {k}")
        np.testing.assert_allclose(
            _n(state.leg_cmd.q_des), _n(bc.leg_controller.command.qDes),
            atol=2e-4, err_msg=f"qDes @ tick {k}")
        # Commanded torque: LEFT leg only (right-leg tau_ff/qdDes inherit
        # the reference's right Jacobian bug; documented above).
        np.testing.assert_allclose(
            _n(tau_ours)[:, :dof], _n(tau_ref)[:, :dof], atol=2e-3,
            err_msg=f"left-leg torque @ tick {k}")

    for k in range(ticks):
        pos, quat, v_b, w_b, q, qd, tau = obs_at(k)
        # reference tick
        bc.set_leg_data(_t(q), _t(qd), _t(tau))
        bc.get_state_estimate(_t(pos), _t(quat), _t(v_b), _t(w_b))
        if k % decim == 0:
            bc.run_mpc()
        bc.run_lowlevel()
        tau_ref = bc.command_joint_torque
        # our tick
        obs = np.concatenate([pos, quat, v_b, w_b, q, qd, tau], axis=1)
        state = core.ingest_state(state, jnp.asarray(obs))
        if k % decim == 0:
            state = our_mock_mpc(state)
        state = core.run_lowlevel(state)
        tau_ours = core.joint_torque(state)
        if k % 100 == 7 or k == ticks - 1:
            compare(k)

    # Episodic reset parity: reset half the envs mid-trajectory.
    ids = torch.tensor([0, 2, 5])
    bc.reset(ids)
    mask = np.zeros(B, bool); mask[[0, 2, 5]] = True
    state = core.reset(state, jnp.asarray(mask))
    np.testing.assert_allclose(
        _n(state.gait_phase), _n(bc.gait_generator.gait_phase), atol=2e-5)
    assert bool(state.mpc_mem.first_run[0]) and bool(state.mpc_mem.first_run[2])
    assert not bool(state.mpc_mem.first_run[1])


# ---------------------------------------------------------------------------
# Wrapper-level lockstep: the public MPCController facade + its properties
# (`mpc_wrapper.py:4-205`)
# ---------------------------------------------------------------------------

def test_wrapper_lockstep_parity(ref):
    """300-tick lockstep at the PUBLIC API level: the reference
    `MPCController` wrapper vs ours, identical mock solver on both sides,
    comparing every readable property each MPC cycle — including the DRL
    knobs (`update_mpc_sampling_time`, `set_swing_parameters`) flipped
    mid-run. The right-leg-Jacobian-derived quantities compare left-leg
    only (documented reference bug); `velocity_trajectory` is asserted to
    RAISE on the reference (reads a nonexistent attribute,
    `mpc_wrapper.py:159-161`) while ours returns the velocity rows."""
    import jax
    import jax.numpy as jnp
    from biped_pympc_tpu import ControllerConf as OurCC, MPCConf as OurMC
    from biped_pympc_tpu import MPCController as OurWrapper
    from biped_pympc_tpu.control import mpc as our_mpc
    from biped_pympc_tpu.ops import qp as qps

    B, ticks, dof, horizon, decim = 6, 300, 5, 10, 10
    dt = 0.001
    rng = np.random.default_rng(11)
    W = (0.3 * rng.standard_normal((12, 12))).astype(np.float32)
    Wt = torch.tensor(W)

    mock_mod = types.ModuleType("biped_pympc.convex_mpc.mpc_controller_cusadi")

    class MPCControllerCusadi(ref.base.BaseMPCController):
        def init_solver(self):
            pass

        def run(self):
            self.compute_knot_points()
            self.compute_horizon_state()
            self.set_initial_state()
            self.compute_reference_trajectory()
            err = self.x0 - self.x_ref[:, 0, :]
            u = err @ Wt.T
            lf, rf = u[:, :3], u[:, 3:6]
            lm, rm = u[:, 6:9].clone(), u[:, 9:12].clone()
            lm[:, 0] = 0.0
            rm[:, 0] = 0.0
            R = self.state_estimate_data.rotation_body
            tb = lambda v: (R.transpose(1, 2) @ v.unsqueeze(-1)).squeeze(-1)
            foot_wrench = torch.cat(
                [-tb(lf), -tb(lm), -tb(rf), -tb(rm)], dim=1)
            return foot_wrench, torch.zeros(self.num_envs)

    mock_mod.MPCControllerCusadi = MPCControllerCusadi
    sys.modules["biped_pympc.convex_mpc.mpc_controller_cusadi"] = mock_mod
    try:
        ref_ctrl = importlib.import_module("biped_pympc.mpc_wrapper").MPCController(
            ref.cfg.ControllerConf(), ref.cfg.MPCConf(solver="cusadi"),
            num_envs=B, device=torch.device("cpu"), gait_id=2)
    finally:
        del sys.modules["biped_pympc.convex_mpc.mpc_controller_cusadi"]

    ours = OurWrapper(OurCC(), OurMC(solver="ric_aug", verbose=False),
                      num_envs=B, gait_id=2)
    core = ours.core
    Wj = jnp.asarray(W)

    def our_mock_run_mpc(state):
        new_mem, x_ref = jax.vmap(
            lambda mem, est, des, dtm: our_mpc.reference_trajectory(
                mem, est, des, dtm, horizon, decim * dt)
        )(state.mpc_mem, state.est, state.des, state.dt_mpc)
        est = state.est
        x0 = jnp.concatenate(
            [est.root_euler, est.root_position,
             est.root_angular_velocity_w, est.root_velocity_w], axis=1)
        u = (x0 - x_ref[:, 0, :]) @ Wj.T
        grf = u.reshape(B, 4, 3)
        grm = grf[:, 2:].at[:, :, 0].set(0.0)
        rot = est.rotation_body
        f_b = jnp.einsum("bji,bkj->bki", rot, grf[:, :2])
        m_b = jnp.einsum("bji,bkj->bki", rot, grm)
        wrench = jnp.concatenate([-f_b, -m_b], axis=2)
        cmd = state.leg_cmd._replace(wrench_ff=wrench)
        zeros_b = jnp.zeros((B,), jnp.float32)
        out = our_mpc.MpcOutput(
            wrench=wrench, cost=zeros_b, x_ref=x_ref, grf_world=u,
            solution=jnp.zeros((B, 24 * horizon), jnp.float32),
            residuals=jnp.zeros((B, 4), jnp.float32))
        state = state._replace(mpc_mem=new_mem, leg_cmd=cmd,
                               x_ref=x_ref, mpc_cost=zeros_b)
        return state, out

    core.run_mpc = our_mock_run_mpc  # mock spliced at the same boundary

    twist = np.zeros((B, 3), np.float32)
    twist[:, 0] = np.linspace(-0.15, 0.4, B)
    twist[:, 2] = np.linspace(-0.2, 0.2, B)
    height = np.full(B, 0.55, np.float32)
    phases = np.linspace(0, 2 * np.pi, B, endpoint=False)

    def obs_at(k):
        t = k * dt
        pos = np.stack([0.1 * np.sin(0.5 * t + phases),
                        0.05 * np.sin(0.3 * t + phases),
                        0.55 + 0.02 * np.sin(t + phases)], axis=1)
        rpy = np.stack([0.04 * np.sin(0.7 * t + phases),
                        0.05 * np.cos(0.9 * t + phases),
                        0.3 * np.sin(0.2 * t + phases)], axis=1)
        cr, sr = np.cos(rpy[:, 0] / 2), np.sin(rpy[:, 0] / 2)
        cp, sp = np.cos(rpy[:, 1] / 2), np.sin(rpy[:, 1] / 2)
        cy, sy = np.cos(rpy[:, 2] / 2), np.sin(rpy[:, 2] / 2)
        quat = np.stack([
            cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], axis=1)
        v_b = np.stack([0.2 * np.sin(t + phases), 0.1 * np.cos(t + phases),
                        0.05 * np.sin(2 * t + phases)], axis=1)
        w_b = np.stack([0.2 * np.sin(t + phases), 0.15 * np.cos(t + phases),
                        0.3 * np.sin(0.5 * t + phases)], axis=1)
        base_q = np.array([0.0, 0.0, 0.45, -0.9, 0.45], np.float32)
        qs = base_q[None, None] + 0.2 * np.sin(
            t + phases[:, None, None] + np.array([[0.0], [np.pi]]))
        q = qs.reshape(B, 2 * dof)
        qd = 0.4 * np.cos(t + phases[:, None]) * np.ones((B, 2 * dof))
        obs = np.concatenate([pos, quat, v_b, w_b, q, qd,
                              np.zeros((B, 2 * dof))], axis=1)
        return obs.astype(np.float32)

    ref_ctrl.set_command(_t(twist), _t(height))
    ours.set_command(twist, height)

    def compare(k):
        pairs = [
            ("ground_reaction_wrench", ours.ground_reaction_wrench,
             ref_ctrl.ground_reaction_wrench, 2e-4, None),
            ("centroidal_accel", ours.centroidal_accel,
             ref_ctrl.centroidal_accel, 2e-3, None),
            ("contact_state", ours.contact_state, ref_ctrl.contact_state,
             0.0, None),
            ("contact_phase", ours.contact_phase, ref_ctrl.contact_phase,
             3e-5, None),
            ("swing_state", ours.swing_state, ref_ctrl.swing_state,
             0.0, None),
            ("swing_phase", ours.swing_phase, ref_ctrl.swing_phase,
             3e-5, None),
            ("foot_placement", ours.foot_placement, ref_ctrl.foot_placement,
             1e-4, None),
            ("foot_placement_b", ours.foot_placement_b,
             ref_ctrl.foot_placement_b, 1e-4, None),
            ("foot_pos_b", ours.foot_pos_b, ref_ctrl.foot_pos_b, 1e-5, None),
            # Jacobian-derived: left leg only (reference right-J bug).
            ("foot_vel_b[left]", ours.foot_vel_b[:, 0],
             ref_ctrl.foot_vel_b[:, 0], 2e-5, None),
            ("ref_foot_vel_b[left]", ours.ref_foot_vel_b[:, 0],
             ref_ctrl.ref_foot_vel_b[:, 0], 2e-3, "swing_left"),
            ("mpc_cost", ours.mpc_cost, ref_ctrl.mpc_cost, 0.0, None),
            ("position_trajectory", ours.position_trajectory,
             ref_ctrl.position_trajectory, 2e-4, None),
            ("swing_foot_trajectory", ours.swing_foot_trajectory,
             ref_ctrl.swing_foot_trajectory, 2e-4, None),
        ]
        sw_left = _n(ours.state.swing_phase)[:, 0] >= 0
        for name, got, want, atol, gate in pairs:
            got, want = _n(got), _n(want)
            if gate == "swing_left":  # stance pDes/vDes is out-of-domain
                got, want = got[sw_left], want[sw_left]
            np.testing.assert_allclose(
                got, want, atol=atol, err_msg=f"{name} @ tick {k}")
        # get_action: left-leg torque columns.
        np.testing.assert_allclose(
            _n(ours.get_action())[:, :dof],
            _n(ref_ctrl.get_action())[:, :dof], atol=2e-3,
            err_msg=f"action @ tick {k}")
        # velocity_trajectory: documented deviation — reference raises.
        with pytest.raises(AttributeError):
            ref_ctrl.velocity_trajectory
        assert _n(ours.velocity_trajectory).shape == (B, horizon, 3)

    for k in range(ticks):
        obs = obs_at(k)
        ref_ctrl.update_state(_t(obs))
        ours.update_state(obs)
        if k % decim == 0:
            ref_ctrl.run_mpc()
            ours.run_mpc()
        ref_ctrl.run_lowlevel()
        ours.run_lowlevel()
        if k == 150:
            # Flip the DRL knobs mid-run on both sides.
            dtm = np.full(B, 0.03, np.float32)
            fh = np.full(B, 0.11, np.float32)
            c1 = np.full(B, 0.3, np.float32)
            c2 = np.full(B, 0.7, np.float32)
            ref_ctrl.update_mpc_sampling_time(_t(dtm))
            ours.update_mpc_sampling_time(dtm)
            ref_ctrl.set_swing_parameters(_t(fh), _t(c1), _t(c2))
            ours.set_swing_parameters(fh, c1, c2)
        if k % 60 == 17 or k == ticks - 1:
            compare(k)


# ---------------------------------------------------------------------------
# T1: the runnable torch parts (`core/robot/t1.py:140-215` analytic IK)
# ---------------------------------------------------------------------------

def test_t1_ik_live_parity(ref, monkeypatch):
    """The reference T1's FK needs unavailable CasADi artifacts, but its
    batched analytic IK and hip locations are pure torch — instantiate
    with the FK loader stubbed and compare live. Targets are reachable
    foot positions generated by OUR chain FK (itself URDF-pinned by
    tests/test_urdf.py); the parity claim is IK agreement on identical
    inputs."""
    t1_mod = importlib.import_module("biped_pympc.core.robot.t1")
    from biped_pympc_tpu.models import t1 as ours

    monkeypatch.setattr(t1_mod.T1, "initialize_kinematics",
                        lambda self: None)
    robot = t1_mod.T1(64, torch.device("cpu"))

    rng = np.random.default_rng(12)
    lo = np.array([-0.4, -0.25, -0.3, 0.0, -0.7, -0.2], np.float32)
    hi = np.array([0.4, 0.25, 0.3, 1.2, 0.4, 0.2], np.float32)
    q = rng.uniform(lo, hi, (64, 6)).astype(np.float32)
    for leg in (0, 1):
        targets = _n(jax.vmap(lambda qq: ours.foot_position(qq, leg))(
            jnp.asarray(q)))
        want = _n(robot.analytical_IK(_t(targets), leg))
        got = _n(jax.vmap(lambda pp: ours.analytical_ik(pp, leg))(
            jnp.asarray(targets)))
        np.testing.assert_allclose(got, want, atol=5e-5,
                                   err_msg=f"T1 IK leg {leg}")

    # Hip horizontal locations and PD/torque-limit constants.
    for leg in (0, 1):
        want_hip = _n(robot.hip_horizontal_location(leg))[0]
        got_hip = _n(ours.hip_horizontal_location(leg, jnp.float32))
        np.testing.assert_allclose(got_hip, want_hip, atol=1e-6)
    np.testing.assert_allclose(list(ours.KP), robot.pd_conf.kp)
    np.testing.assert_allclose(list(ours.KD), robot.pd_conf.kd)
    np.testing.assert_allclose(list(ours.TORQUE_LIMIT),
                               robot.pd_conf.torque_limit)
    assert ours.MASS == robot.mass and ours.MU == robot.mu
    np.testing.assert_allclose(ours.I_BODY, _n(robot.I_body))
