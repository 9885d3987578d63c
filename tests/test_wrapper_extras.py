"""Wrapper extras: cycloid swing curve, checkpoint/restore, solve-time print."""

import numpy as np
import pytest

from biped_pympc_tpu import ControllerConf, MPCConf, MPCController


def _obs(batch):
    obs = np.zeros((batch, 43), dtype=np.float32)
    obs[:, 2] = 0.55
    obs[:, 3] = 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], dtype=np.float32)
    obs[:, 13:18] = q0
    obs[:, 18:23] = q0
    return obs


def _step(ctrl, obs, n=5, mpc=True):
    twist = np.zeros((obs.shape[0], 3), np.float32)
    twist[:, 0] = 0.3
    ctrl.set_command(twist, np.full(obs.shape[0], 0.55, np.float32))
    for i in range(n):
        ctrl.update_state(obs)
        if mpc and i % 10 == 0:
            ctrl.run_mpc()
        ctrl.run_lowlevel()


def test_cycloid_swing_curve():
    obs = _obs(2)
    ctrl = MPCController(
        ControllerConf(swing_curve="cycloid"), MPCConf(), num_envs=2, gait_id=2
    )
    _step(ctrl, obs, n=8, mpc=False)
    p = np.asarray(ctrl.ref_foot_pos_b)
    assert np.isfinite(p[:, 1]).all()  # right foot swings at phase 0
    # swing target differs from the bezier default at the same phase
    ctrl_b = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=2)
    _step(ctrl_b, obs, n=8, mpc=False)
    p_b = np.asarray(ctrl_b.ref_foot_pos_b)
    assert not np.allclose(p[:, 1], p_b[:, 1])


@pytest.mark.slow
def test_checkpoint_roundtrip(tmp_path):
    obs = _obs(3)
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=3, gait_id=2)
    _step(ctrl, obs, n=7)
    path = str(tmp_path / "state.npz")
    ctrl.save_state(path)
    phase_saved = np.asarray(ctrl.state.gait_phase).copy()

    ctrl2 = MPCController(ControllerConf(), MPCConf(), num_envs=3, gait_id=2)
    ctrl2.load_state(path)
    np.testing.assert_array_equal(np.asarray(ctrl2.state.gait_phase), phase_saved)
    np.testing.assert_allclose(
        np.asarray(ctrl2.state.leg_cmd.wrench_ff),
        np.asarray(ctrl.state.leg_cmd.wrench_ff),
    )
    # restored controller continues stepping
    _step(ctrl2, obs, n=2)
    assert np.isfinite(np.asarray(ctrl2.get_action())).all()


def test_checkpoint_batch_mismatch_rejected(tmp_path):
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    path = str(tmp_path / "s.npz")
    ctrl.save_state(path)
    ctrl4 = MPCController(ControllerConf(), MPCConf(), num_envs=4, gait_id=1)
    with pytest.raises(ValueError, match="mismatch"):
        ctrl4.load_state(path)


@pytest.mark.slow
def test_print_solve_time(capsys):
    obs = _obs(2)
    ctrl = MPCController(
        ControllerConf(), MPCConf(print_solve_time=True), num_envs=2, gait_id=1
    )
    ctrl.set_command(np.zeros((2, 3), np.float32), np.full(2, 0.55, np.float32))
    ctrl.update_state(obs)
    ctrl.run_mpc()
    ctrl.run_lowlevel()
    captured = capsys.readouterr().out
    assert "MPC solve time took" in captured
    assert "low level control took" in captured


def test_set_srbd_residual_end_to_end():
    """The learned-dynamics-residual hook the reference only declares
    (`mpc_wrapper.py:66-67`): (B,12,12) A/B residuals reach the QP and
    change the MPC solution; zero residuals reproduce the residual-free
    wrench exactly; clearing restores the original pytree structure."""
    obs = _obs(2)
    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    _step(ctrl, obs, n=1)
    w_base = np.asarray(ctrl.ground_reaction_wrench).copy()

    # Zero residuals: bit-for-bit the same wrench on a fresh controller.
    ctrl0 = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    ctrl0.set_srbd_residual(np.zeros((2, 12, 12), np.float32),
                            np.zeros((2, 12, 12), np.float32))
    _step(ctrl0, obs, n=1)
    np.testing.assert_array_equal(
        np.asarray(ctrl0.ground_reaction_wrench), w_base)

    # A real B-residual (scale the force columns' effect) shifts the GRFs.
    rb = np.zeros((2, 12, 12), np.float32)
    rb[:, 9:12, 0:3] = 0.25 * np.eye(3)  # feet 25% "stronger" on v_dot
    rb[:, 9:12, 3:6] = 0.25 * np.eye(3)
    ctrl_r = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    ctrl_r.set_srbd_residual(np.zeros((2, 12, 12), np.float32), rb)
    _step(ctrl_r, obs, n=1)
    w_res = np.asarray(ctrl_r.ground_reaction_wrench)
    assert np.isfinite(w_res).all()
    # the model thinks forces act stronger -> the QP commands smaller fz
    assert abs(w_res[0, 0, 2]) < abs(w_base[0, 0, 2])

    # Clearing goes back to the residual-free structure and wrench.
    ctrl_r.set_srbd_residual(None, None)
    assert ctrl_r.state.residual_A is None
    _step(ctrl_r, obs, n=1)
    np.testing.assert_allclose(
        np.asarray(ctrl_r.ground_reaction_wrench), w_base, atol=1e-4)

    # Shape validation.
    with pytest.raises(ValueError, match="expects shapes"):
        ctrl_r.set_srbd_residual(np.zeros((2, 12, 11), np.float32),
                                 np.zeros((2, 12, 12), np.float32))


def _step_moving(ctrl, n):
    """Step with the body translating forward each tick (world-frame swing
    planning only differs from base-frame when the body moves mid-swing)."""
    obs = _obs(2)
    obs[:, 7] = 0.3
    twist = np.zeros((2, 3), np.float32)
    twist[:, 0] = 0.3
    ctrl.set_command(twist, np.full(2, 0.55, np.float32))
    for i in range(n):
        obs[:, 0] += 0.003  # body advances 3 mm per tick
        ctrl.update_state(obs)
        ctrl.run_lowlevel()


def test_world_frame_swing_reference():
    """World-frame swing planning (`swing_leg_controller.py:236-258`):
    finite body-frame targets; world-latched liftoff position recedes in the
    body frame as the body translates, unlike the base-frame plan. With a
    static body both frames coincide (verified: identical to f32 eps)."""
    cfg_w = ControllerConf(swing_reference_frame="world")
    ctrl_w = MPCController(cfg_w, MPCConf(), num_envs=2, gait_id=2)
    _step_moving(ctrl_w, n=8)
    p_w = np.asarray(ctrl_w.ref_foot_pos_b)
    assert np.isfinite(p_w).all()

    ctrl_b = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=2)
    _step_moving(ctrl_b, n=8)
    p_b = np.asarray(ctrl_b.ref_foot_pos_b)
    assert not np.allclose(p_w[:, 1], p_b[:, 1], atol=1e-5)


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    """A checkpoint saved after set_srbd_residual must not load
    silently into a residual-free controller (and vice versa) — the saved
    treedef is validated and the error names set_srbd_residual."""
    import numpy as _np
    import pytest as _pytest

    ctrl = MPCController(
        ControllerConf(), MPCConf(verbose=False), num_envs=2)
    ctrl.set_srbd_residual(
        _np.zeros((2, 12, 12), _np.float32), _np.zeros((2, 12, 12), _np.float32))
    path = str(tmp_path / "with_residual.npz")
    ctrl.save_state(path)

    fresh = MPCController(
        ControllerConf(), MPCConf(verbose=False), num_envs=2)
    with _pytest.raises(ValueError, match="set_srbd_residual"):
        fresh.load_state(path)

    # Matching the structure first makes the same checkpoint load.
    fresh.set_srbd_residual(
        _np.ones((2, 12, 12), _np.float32), _np.ones((2, 12, 12), _np.float32))
    fresh.load_state(path)
    _np.testing.assert_array_equal(_np.asarray(fresh.state.residual_A),
                                   _np.zeros((2, 12, 12)))

    # Reverse direction: residual-free checkpoint into a residual'd
    # controller is also a clear error, not an opaque KeyError.
    path2 = str(tmp_path / "plain.npz")
    MPCController(ControllerConf(), MPCConf(verbose=False),
                  num_envs=2).save_state(path2)
    with _pytest.raises(ValueError, match="set_srbd_residual"):
        fresh.load_state(path2)
