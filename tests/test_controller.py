"""End-to-end controller tests: standing/walking behavior, reset, sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from biped_pympc_tpu import ControllerConf, MPCConf, MPCController
from biped_pympc_tpu.models.srbd import GRAVITY


def _hector_obs(batch, z=0.55):
    obs = np.zeros((batch, 43), dtype=np.float32)
    obs[:, 2] = z
    obs[:, 3] = 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], dtype=np.float32)
    obs[:, 13:18] = q0
    obs[:, 18:23] = q0
    return obs


@pytest.fixture(scope="module")
def standing_ctrl():
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    obs = _hector_obs(2)
    ctrl.set_command(np.zeros((2, 3), np.float32), np.full(2, 0.55, np.float32))
    ctrl.update_state(obs)
    ctrl.run_mpc()
    ctrl.run_lowlevel()
    return ctrl


def test_standing_grf_supports_weight(standing_ctrl):
    """Double support at rest: vertical GRFs sum to ~weight, split evenly."""
    wrench = np.asarray(standing_ctrl.ground_reaction_wrench)  # (B, 2, 6)
    fz = -wrench[:, :, 2]
    weight = 13.856 * GRAVITY
    np.testing.assert_allclose(fz.sum(axis=1), weight, rtol=0.1)
    np.testing.assert_allclose(fz[:, 0], fz[:, 1], rtol=0.05)


def test_standing_no_mx_moment(standing_ctrl):
    """Mx is unactuated: zero in the commanded wrench."""
    wrench = np.asarray(standing_ctrl.ground_reaction_wrench)
    np.testing.assert_allclose(wrench[:, :, 3], 0.0, atol=1e-5)


def test_standing_torques_within_limits(standing_ctrl):
    tau = np.asarray(standing_ctrl.get_action())
    assert tau.shape == (2, 10)
    limit = np.array([33.5, 33.5, 33.5, 67.0, 33.5] * 2)
    assert (np.abs(tau) <= limit + 1e-5).all()


def test_wrapper_property_shapes(standing_ctrl):
    c = standing_ctrl
    assert np.asarray(c.centroidal_accel).shape == (2, 6)
    assert np.asarray(c.contact_state).shape == (2, 2)
    assert np.asarray(c.foot_placement).shape == (2, 2, 3)
    assert np.asarray(c.ref_foot_pos_b).shape == (2, 2, 3)
    assert np.asarray(c.foot_pos_b).shape == (2, 2, 3)
    assert np.asarray(c.mpc_cost).shape == (2,)
    assert np.asarray(c.position_trajectory).shape == (2, 10, 3)
    assert np.asarray(c.swing_foot_trajectory).shape == (2, 10, 3)


def test_walking_swing_progression():
    """Walking gait: phases advance, the swing foot gets zero GRF, and the
    swing target tracks the Raibert heuristic."""
    B = 2
    ctrl = MPCController(
        ControllerConf(ssp_durations=5, dsp_durations=0),
        MPCConf(),
        num_envs=B,
        gait_id=2,
    )
    obs = _hector_obs(B)
    twist = np.zeros((B, 3), np.float32)
    twist[:, 0] = 0.3
    ctrl.set_command(twist, np.full(B, 0.55, np.float32))

    swing_states = []
    for step in range(25):
        ctrl.update_state(obs)
        if step % 10 == 0:
            ctrl.run_mpc()
        ctrl.run_lowlevel()
        swing_states.append(np.asarray(ctrl.swing_state)[0])
    swing_states = np.stack(swing_states)
    # at phase 0 the right foot swings (gait layout `gait_generator.py:24-31`)
    assert swing_states[0, 1] == 1.0 and swing_states[0, 0] == 0.0
    # swing foot carries no force
    wrench = np.asarray(ctrl.ground_reaction_wrench)
    assert abs(wrench[0, 1, 2]) < 1.0  # right foot swinging
    assert wrench[0, 0, 2] < -50.0  # left foot loaded
    # phase advanced
    assert float(np.asarray(ctrl.state.gait_phase)[0]) > 0.05


def test_per_env_contact_parameters_bind():
    """Per-env f_max caps the stance force; per-env mu limits tangentials.

    Both constants are baked into the reference's compiled kernel
    (`srbd_constraints.py:31,144-227`); here they are per-env data
    (`MPCController.set_contact_parameters`). Env 1 gets a force cap below
    half the robot's weight and near-zero friction; env 0 keeps defaults.
    """
    B = 2
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=B, gait_id=1)
    obs = _hector_obs(B)
    twist = np.zeros((B, 3), np.float32)
    twist[:, 0] = 0.4  # demand tangential force
    ctrl.set_command(twist, np.full(B, 0.55, np.float32))
    ctrl.set_contact_parameters(
        mu=np.array([1.0, 0.02], np.float32),
        f_max=np.array([500.0, 50.0], np.float32),
    )
    ctrl.update_state(obs)
    ctrl.run_mpc()

    wrench = np.asarray(ctrl.ground_reaction_wrench)  # (B, 2, 6), -F_body
    fz = -wrench[:, :, 2]
    weight = 13.856 * GRAVITY
    # env 0 unconstrained: carries at least full weight (the 0.4 m/s
    # command adds vertical redistribution on top); env 1: capped at
    # 50 N/foot, so it cannot.
    assert fz[0].sum() > 0.9 * weight
    assert fz[0].max() > 50.0 + 1e-3
    assert (fz[1] <= 50.0 + 1e-3).all(), fz[1]
    # env 1's friction pyramid: |fx| <= mu fz (plus solver slack).
    fx = np.abs(wrench[:, :, 0])
    assert (fx[1] <= 0.02 * fz[1] + 0.5).all(), (fx[1], fz[1])
    assert fx[0].max() > fx[1].max()


@pytest.mark.slow
def test_solver_foot_split_config_matches_dense():
    """`MPCConf.solver_foot_split` reproduces the dense stage factorization.

    (Slow tier: compiles two full controllers; the underlying split-vs-dense
    exactness is covered in the fast tier by `test_foot_split_exactness`.)

    The foot-split decomposition is exact (block-diagonal by foot), so at
    f64 the full controller step must give identical GRFs and torques up to
    roundoff of the reordered reductions."""
    B = 2
    outs = []
    for split in (False, True):
        ctrl = MPCController(
            ControllerConf(),
            MPCConf(solver="ric_aug", solver_foot_split=split, verbose=False),
            num_envs=B, gait_id=2, dtype=jnp.float64,
        )
        obs = _hector_obs(B)
        twist = np.zeros((B, 3), np.float32)
        twist[:, 0] = 0.3
        ctrl.set_command(twist, np.full(B, 0.55, np.float32))
        ctrl.update_state(obs)
        ctrl.run_mpc()
        ctrl.run_lowlevel()
        outs.append((np.asarray(ctrl.ground_reaction_wrench),
                     np.asarray(ctrl.get_action())))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-7)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-7)


def test_reset_masks_only_selected_envs():
    B = 3
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=B, gait_id=2)
    obs = _hector_obs(B)
    ctrl.set_command(np.zeros((B, 3), np.float32), np.full(B, 0.55, np.float32))
    for _ in range(5):
        ctrl.update_state(obs)
        ctrl.run_mpc()  # clears the first_run latch
        ctrl.run_lowlevel()
    phase_before = np.asarray(ctrl.state.gait_phase).copy()
    assert (phase_before > 0).all()
    ctrl.reset(np.array([1]))
    phase_after = np.asarray(ctrl.state.gait_phase)
    assert phase_after[1] == 0.0
    np.testing.assert_allclose(phase_after[[0, 2]], phase_before[[0, 2]])
    assert bool(np.asarray(ctrl.state.mpc_mem.first_run)[1])
    assert not bool(np.asarray(ctrl.state.mpc_mem.first_run)[0])


def test_unknown_solver_rejected():
    """A typo'd solver name must fail loudly, not silently run tridiag."""
    with pytest.raises(ValueError, match="unknown MPCConf.solver"):
        MPCController(
            ControllerConf(), MPCConf(solver="bcrr"), num_envs=1, gait_id=1
        )


@pytest.mark.parametrize("platform,dtype,conf,want", [
    ("cpu", jnp.float32, {}, "ric_aug"),
    ("gpu", jnp.float32, {}, "fused_ric_aug"),
    ("gpu", jnp.float64, {}, "ric_aug"),
    ("gpu", jnp.float32, {"adaptive_tol": 1e-2}, "ric_aug"),
    ("gpu", jnp.float32, {"solver_refine_steps": 2}, "ric_aug"),
    ("gpu", jnp.float32, {"solver_foot_split": False}, "ric_aug"),
    ("gpu", jnp.float32, {"solver_kkt_scale": "jacobi"}, "ric_aug"),
    ("gpu", jnp.float32, {"solver": "tridiag_aug"}, "tridiag_aug"),
    ("cpu", jnp.float32, {"solver": "fused_ric_aug"}, "fused_ric_aug"),
])
def test_auto_solver_resolution(monkeypatch, platform, dtype, conf, want):
    """"auto" runs the fused kernel only where it was measured faster (a
    GPU, float32, fixed iterations, its one option set); an explicit name
    is kept as given."""
    from biped_pympc_tpu.control import controller

    monkeypatch.setattr(controller.jax, "default_backend", lambda: platform)
    cfg = MPCConf(verbose=False, **conf)
    assert controller.resolve_solver(cfg, dtype) == want


def test_controller_runs_the_resolved_solver():
    ctrl = MPCController(ControllerConf(), MPCConf(verbose=False),
                         num_envs=1, gait_id=1)
    assert ctrl.core.solver == "ric_aug"  # "auto" on the CPU
    assert ctrl.core.opts.backend == "ric_aug"


@pytest.mark.parametrize("old,new", [
    ("pallas_ric_aug", "ric_aug"), ("pallas_hybrid", "ric_aug"),
    ("pallas", "tridiag"),
])
def test_removed_solver_names_point_to_replacement(old, new):
    """A solver name of the removed Pallas kernel family raises and names
    the solver that replaces it."""
    with pytest.raises(ValueError, match=f"removed; use '{new}'"):
        MPCController(
            ControllerConf(), MPCConf(solver=old, verbose=False),
            num_envs=1, gait_id=1,
        )


def test_t1_standing():
    B = 2
    ctrl = MPCController(
        ControllerConf(), MPCConf(robot="T1"), num_envs=B, gait_id=1
    )
    obs = np.zeros((B, 49), dtype=np.float32)
    obs[:, 2] = 0.68
    obs[:, 3] = 1.0
    ctrl.set_command(np.zeros((B, 3), np.float32), np.full(B, 0.68, np.float32))
    ctrl.update_state(obs)
    ctrl.run_mpc()
    ctrl.run_lowlevel()
    tau = np.asarray(ctrl.get_action())
    assert tau.shape == (B, 12)
    assert np.isfinite(tau).all()
    fz = -np.asarray(ctrl.ground_reaction_wrench)[:, :, 2].sum(axis=1)
    np.testing.assert_allclose(fz, 40.0 * GRAVITY, rtol=0.25)


@pytest.mark.slow
def test_sharded_step_matches_single_device():
    """The mesh-sharded control step equals the unsharded one."""
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.parallel import mesh as pmesh

    assert jax.device_count() >= 8, "conftest sets 8 virtual CPU devices"
    core = BipedControllerCore(ControllerConf(), MPCConf(), gait_id=2)
    B = 16
    state = core.init_state(B)
    obs = jnp.asarray(_hector_obs(B))
    twist = jnp.zeros((B, 3), jnp.float32).at[:, 0].set(0.2)
    height = jnp.full((B,), 0.55, jnp.float32)

    _, tau_single, out_single = core.control_step(state, obs, twist, height)

    mesh = pmesh.make_mesh(jax.devices()[:8])
    sharded_state = pmesh.shard_state(core.init_state(B), mesh)
    step = pmesh.sharded_step(
        lambda st, o, tw, h: core.control_step(st, o, tw, h), mesh
    )
    _, tau_sharded, out_sharded = step(sharded_state, obs, twist, height)

    np.testing.assert_allclose(
        np.asarray(tau_sharded), np.asarray(tau_single), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out_sharded.wrench), np.asarray(out_single.wrench), atol=1e-4
    )
    summary = pmesh.metrics_summary(out_sharded.cost, mesh)
    np.testing.assert_allclose(
        float(summary["mean"]), float(np.mean(np.asarray(out_single.cost))),
        rtol=1e-5,
    )


@pytest.mark.slow
def test_shard_map_step_matches_single_device():
    """The explicit-SPMD (shard_map) step equals the unsharded one, with the
    pmean-reduced global metric matching the batch mean."""
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.parallel import mesh as pmesh

    assert jax.device_count() >= 8
    core = BipedControllerCore(ControllerConf(), MPCConf(), gait_id=2)
    B = 16
    state = core.init_state(B)
    obs = jnp.asarray(_hector_obs(B))
    twist = jnp.zeros((B, 3), jnp.float32).at[:, 0].set(0.2)
    height = jnp.full((B,), 0.55, jnp.float32)

    _, tau_single, out_single = core.control_step(state, obs, twist, height)

    mesh = pmesh.make_mesh(jax.devices()[:8])
    step = pmesh.shard_map_step(
        lambda st, o, tw, h: core.control_step(st, o, tw, h), mesh
    )
    _, tau_sm, out_sm, mean_cost = step(
        core.init_state(B), obs, twist, height
    )
    np.testing.assert_allclose(
        np.asarray(tau_sm), np.asarray(tau_single), atol=1e-5
    )
    np.testing.assert_allclose(
        float(mean_cost), float(np.mean(np.asarray(out_single.cost))), rtol=1e-5
    )


def _yawed_obs(yaw, z=0.55):
    """Single-env obs at body yaw `yaw`, walking-ready joint pose."""
    obs = _hector_obs(1, z=z)[0]
    # quat wxyz for pure yaw
    obs[3] = np.cos(yaw / 2)
    obs[6] = np.sin(yaw / 2)
    return obs


@pytest.mark.slow
def test_yaw_rotational_invariance():
    """contact_frame="yaw": the body-frame MPC wrench is heading-invariant.

    The reference's QP hardcodes the Mx=0 equality and toe/heel line-
    contact rows in WORLD axes (`srbd_constraints.py:144-227`), so its
    solution is only correct near yaw = 0 (mod pi) — at yaw ~ pi/2 the QP
    forbids the ankle pitch moment entirely (measured: the closed loop
    falls once |yaw| passes ~1.2 rad). The "yaw" contact frame expresses u
    in yaw-aligned axes, restoring rotational invariance: two physically
    identical states differing only by heading must produce the same
    body-frame wrench."""
    yaws = [0.0, 0.7, 1.5, 2.8]
    wrenches = {}
    for frame in ("yaw", "world"):
        cfg = MPCConf(solver="tridiag", contact_frame=frame)
        ctrl = MPCController(ControllerConf(), cfg, num_envs=len(yaws),
                             gait_id=2)
        obs = np.stack([_yawed_obs(y) for y in yaws])
        # body-frame forward velocity command, identical for every heading
        ctrl.set_command(
            np.tile(np.array([[0.3, 0.0, 0.0]], np.float32), (len(yaws), 1)),
            np.full(len(yaws), 0.55, np.float32),
        )
        ctrl.update_state(obs)
        ctrl.run_mpc()
        wrenches[frame] = np.asarray(ctrl.state.leg_cmd.wrench_ff)
    w = wrenches["yaw"]
    # <= ~2 N deviation on ~156 N forces (f32 20-iteration-cap iterate
    # noise); the world frame violates invariance by 9.6-25.5 N here.
    for i in range(1, len(yaws)):
        np.testing.assert_allclose(w[i], w[0], atol=3.0, rtol=0.02)
    # The world frame (reference parity) is NOT invariant — the yaw mode
    # must actually change the answer at yaw 1.5 or this test tests nothing.
    w_world = wrenches["world"]
    assert np.abs(w_world[2] - w_world[0]).max() > 8.0


@pytest.mark.slow
def test_yaw_mode_matches_reference_at_zero_yaw():
    """At yaw = 0 the yaw-aligned frame IS the world frame: contact_frame
    must not perturb the reference-parity solution."""
    obs = _hector_obs(1)
    outs = {}
    for frame in ("world", "yaw"):
        cfg = MPCConf(solver="tridiag", contact_frame=frame)
        ctrl = MPCController(ControllerConf(), cfg, num_envs=1, gait_id=2)
        ctrl.set_command(np.array([[0.3, 0.0, 0.0]], np.float32),
                         np.full(1, 0.55, np.float32))
        ctrl.update_state(obs)
        ctrl.run_mpc()
        outs[frame] = np.asarray(ctrl.state.leg_cmd.wrench_ff)
    np.testing.assert_allclose(outs["yaw"], outs["world"],
                               atol=1e-3, rtol=1e-4)
