"""RL-MPC training loop (ARS over the DRL knobs) — end-to-end smoke.

Covers the capability the reference is built for but does not ship (its RL
training lives in external IsaacLab envs): per-env policy perturbations
through the batched MPC knobs, group-wise return estimation, and a policy
update step.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import train_rl_mpc as trm
import train_rl_mpc_tpu as trm_dev
from rl_env import RlMpcEnv
import rl_env_tpu

import pytest

pytestmark = pytest.mark.slow  # integration tier: pytest -m slow


def test_ars_trains_and_updates_policy():
    w, history = trm.train(iters=2, n_dirs=2, envs_per=1, steps=6,
                           verbose=False, seed=1)
    assert w.shape == (trm.ACT_DIM, trm.OBS_DIM)
    assert np.linalg.norm(w) > 0.0, "policy never updated"
    assert len(history) == 2 and np.isfinite(history).all()
    # Walking with small knob perturbations should keep positive reward.
    assert history[-1] > 0.0


def test_device_env_matches_host_env():
    """One population evaluation, host loop vs the single-dispatch device
    rollout (host-loop == on-device returns for one iteration): same per-env policies, same step count,
    same solver -> same per-env returns up to f32-vs-mixed-f64 plant
    drift over the rollout."""
    import jax.numpy as jnp

    num_envs, steps = 3, 4
    rng = np.random.default_rng(0)
    w_per_env = (0.02 * rng.standard_normal(
        (num_envs, rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM))).astype(
            np.float32)

    # Host loop (rl_env.RlMpcEnv semantics are the contract).
    env = RlMpcEnv(num_envs=num_envs, vx_cmd=0.3, solver="tridiag_aug")
    obs = env.reset()
    host_total = np.zeros(num_envs)
    for _ in range(steps):
        action = np.tanh(np.einsum("bao,bo->ba", w_per_env, obs))
        obs, reward, done, _ = env.step(action)
        host_total += reward

    # Device: one jitted scan.
    env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(
        num_envs, vx_cmd=0.3, solver="tridiag_aug")
    rollout = rl_env_tpu.make_rollout(env_step, rl_obs, steps)
    carry, dev_total = rollout(reset_all(), jnp.asarray(w_per_env))
    dev_total = np.asarray(dev_total, np.float64)

    np.testing.assert_allclose(dev_total, host_total, atol=2e-2)


def test_device_ars_trains_and_updates_policy():
    """Device-resident ARS end to end on the CPU backend: two iterations,
    policy moves, returns finite and positive (walking succeeds)."""
    w, history, stats = trm_dev.train(
        iters=2, n_dirs=2, envs_per=1, steps=5, solver="tridiag_aug",
        verbose=False, seed=1)
    assert w.shape == (rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM)
    assert np.linalg.norm(w) > 0.0, "policy never updated"
    assert len(history) == 2 and np.isfinite(history).all()
    assert history[-1] > 0.0
    assert stats["env_steps_per_s"] > 0


def test_device_env_mass_error_task():
    """plant_mass_scale injects MPC-vs-plant model error (the RL-MPC
    compensation task): the degraded plant scores lower than nominal
    under the zero policy, and a hand-crafted compensating policy (a
    constant negative-z SRBD residual via the action map) recovers part
    of the gap — i.e. the task is learnable through the action interface."""
    import jax.numpy as jnp

    def run(scale, w):
        env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(
            3, solver="tridiag_aug", plant_mass_scale=scale)
        rollout = rl_env_tpu.make_rollout(env_step, rl_obs, 5)
        _, ret = rollout(reset_all(), w)
        return float(np.asarray(ret).mean())

    w0 = jnp.zeros((3, rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM), jnp.float32)
    # action[6] = residual_lin_z; obs[3] = height ~0.55 -> tanh(-2*0.55) ~ -0.8
    w_comp = w0.at[:, 6, 3].set(-2.0)

    r_nom = run(1.0, w0)
    r_deg = run(1.3, w0)
    r_fix = run(1.3, w_comp)
    assert r_deg < r_nom, (r_deg, r_nom)
    assert r_fix > r_deg, (r_fix, r_deg)


def test_device_env_matrix_residual_actions():
    """Device-env parity with the host env's matrix_residual knob: 16-dim
    actions drive the (12,12) B residual inside the jitted rollout; a
    force-effectiveness residual changes the trajectory vs the zero
    policy, everything stays finite."""
    import jax.numpy as jnp

    env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(
        2, solver="tridiag_aug", matrix_residual=True)
    rollout = rl_env_tpu.make_rollout(env_step, rl_obs, 3)

    w0 = jnp.zeros((2, rl_env_tpu.ACT_DIM_MATRIX, rl_env_tpu.OBS_DIM),
                   jnp.float32)
    carry0, ret0 = rollout(reset_all(), w0)
    # constant force-effectiveness residual via the height obs feature
    w1 = w0.at[:, 10:13, 3].set(2.0)
    carry1, ret1 = rollout(reset_all(), w1)

    assert np.isfinite(np.asarray(ret0)).all()
    assert np.isfinite(np.asarray(ret1)).all()
    assert carry1.state.residual_B is not None
    assert not np.allclose(np.asarray(carry0.x), np.asarray(carry1.x),
                           atol=1e-4)


def test_sharded_training_rollout_matches_single_device():
    """The ARS population evaluation sharded over
    the 8-virtual-device mesh returns the SAME per-env returns as the
    single-device rollout (per-env independence => sharding is a pure
    layout change)."""
    import jax
    import jax.numpy as jnp
    from biped_pympc_tpu.parallel import mesh as pmesh

    assert jax.device_count() >= 8
    num_envs, steps = 16, 3
    rng = np.random.default_rng(1)
    w = (0.02 * rng.standard_normal(
        (num_envs, rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM))).astype(
            np.float32)

    env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(
        num_envs, vx_cmd=0.3, solver="tridiag_aug")
    rollout = jax.jit(rl_env_tpu.make_rollout(env_step, rl_obs, steps))
    _, ret_single = rollout(reset_all(), jnp.asarray(w))

    mesh = pmesh.make_mesh(jax.devices()[:8])
    sh_rollout, carry0, _ = trm_dev.make_sharded_training(
        mesh, num_envs, steps=steps, solver="tridiag_aug")
    _, ret_sh = sh_rollout(carry0, jax.device_put(
        jnp.asarray(w), pmesh.batch_sharding(mesh)))

    np.testing.assert_allclose(
        np.asarray(ret_sh), np.asarray(ret_single), atol=1e-4)


def test_train_with_mesh_runs_ars_iteration():
    """train(mesh=...) completes ARS iterations through the sharded
    rollout and updates the policy."""
    import jax
    from biped_pympc_tpu.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(jax.devices()[:8])
    w, history, _ = trm_dev.train(
        iters=2, n_dirs=2, envs_per=4, steps=3, solver="tridiag_aug",
        verbose=False, mesh=mesh)
    assert len(history) == 2 and np.isfinite(history).all()
    assert np.linalg.norm(w) > 0  # the update moved the policy


def test_matrix_residual_represents_mass_error_exactly():
    """Mechanism check: a 30% plant mass error is
    EXACTLY representable by the B-matrix force-effectiveness action dims
    (true v_dot response F/(1.3 m) == modeled (1 + 0.3 a)/m F at
    a = (1/1.3 - 1)/0.3), while a constant accel residual can only match
    it on average (the error is proportional to the commanded force,
    which swings ~2x between single and double support). Measured on the
    deterministic 25-step loop: the exact matrix action recovers the full
    injected loss; the best-average accel action recovers about half."""
    import jax
    import jax.numpy as jnp

    num_envs, steps = 4, 25

    def ret_with(action_fill, mass_scale):
        env_step, reset_all, _, _ = rl_env_tpu.make_device_env(
            num_envs, vx_cmd=0.3, solver="tridiag_aug",
            matrix_residual=True, plant_mass_scale=mass_scale)
        carry = reset_all()
        total = np.zeros(num_envs, np.float64)
        action = jnp.zeros((num_envs, 16), jnp.float32)
        for i, v in action_fill.items():
            action = action.at[:, i].set(v)
        step = jax.jit(env_step)
        for _ in range(steps):
            carry, reward, _ = step(carry, action)
            total += np.asarray(reward, np.float64)
        return float(total.mean())

    r_nom = ret_with({}, 1.0)
    r_brk = ret_with({}, 1.3)
    a = (1.0 / 1.3 - 1.0) / 0.3  # exact effectiveness correction, in range
    r_fix = ret_with({10: a, 11: a, 12: a}, 1.3)
    # Best-average constant accel: z shortfall ~ -(0.3/1.3) g in stance.
    r_acc = ret_with({6: -2.26}, 1.3)

    loss = r_nom - r_brk
    assert loss > 0.15, (r_nom, r_brk)
    gain_fix = r_fix - r_brk
    gain_acc = r_acc - r_brk
    assert gain_fix > 0.9 * loss, (loss, gain_fix)
    assert gain_fix > 2.0 * gain_acc, (gain_fix, gain_acc)


def test_plant_force_scale_injects_input_proportional_error():
    """plant_force_scale plumbing: the scaled plant integrates different
    dynamics than the nominal one under the same actions (and only the
    force response changes — zero commanded force = identical step)."""
    import jax
    import jax.numpy as jnp

    num_envs = 2
    mk = lambda fs: rl_env_tpu.make_device_env(
        num_envs, vx_cmd=0.3, solver="tridiag_aug", plant_force_scale=fs)
    env_n, reset_n, _, _ = mk(None)
    env_s, reset_s, _, _ = mk((1.0, 1.0, 0.7))
    a = jnp.zeros((num_envs, 10), jnp.float32)
    (state_n, x_n, _), _, _ = env_n(reset_n(), a)
    (state_s, x_s, _), _, _ = env_s(reset_s(), a)
    assert not np.allclose(np.asarray(x_n), np.asarray(x_s), atol=1e-6)
    # z-velocity responds less on the weakened plant during stance.
    assert np.asarray(x_s)[:, 11].mean() < np.asarray(x_n)[:, 11].mean()
