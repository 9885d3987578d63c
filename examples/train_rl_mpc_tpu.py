"""RL-MPC training with the environment ON the device.

`train_rl_mpc.py` proves the ARS learning loop but evaluates the population
through the host `RlMpcEnv` — one dispatch per controller call, so the rate
of the compiled rollout (`tpu_rollout.py`) never reaches training. Here the entire population evaluation is ONE jitted
device program (`rl_env_tpu.make_rollout`): every perturbation direction
owns a group of envs carrying its own policy parameters as data, the full
`steps x decimation` closed loop (MPC solves included) runs in a `lax.scan`,
and the only host work per ARS iteration is the tiny (10 x 14) weight
update. This is the RL-MPC product shape the reference advertises
(`README.md:1-3`) on device terms: policy update is the only host boundary.

Run:  python examples/train_rl_mpc_tpu.py [--iters 10] [--dirs 4]
          [--envs-per 4] [--steps 40] [--bench]
`--bench` appends a learning-curve + throughput artifact (with the device it
ran on) to results/train_rl_mpc_tpu.jsonl.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from rl_env_tpu import (  # noqa: E402  (examples-local module)
    ACT_DIM, ACT_DIM_MATRIX, OBS_DIM, make_device_env, make_rollout,
)


def _shard_rollout(mesh, rollout_fn):
    """Jit a population rollout under shard_map (env axis over the mesh).

    Single definition shared by `make_sharded_training` and
    `train(mesh=...)` so the sharding wiring cannot diverge.
    """
    import jax.sharding as jsh

    from biped_pympc_tpu.parallel import mesh as pmesh

    spec = jsh.PartitionSpec(pmesh.DATA_AXIS)
    return jax.jit(pmesh.shard_map_compat(
        rollout_fn, mesh, (spec, spec), (spec, spec)))


def _apply_newton_iterations(core, n):
    """Mutate the solver iteration count BEFORE the first trace (20 = the
    reference default = no-op)."""
    if n and n != 20:
        core.opts = core.opts._replace(iterations=n)


def make_sharded_training(mesh, num_envs: int, steps: int = 40,
                          solver: str = "auto",
                          newton_iterations: int | None = None,
                          plant_mass_scale: float = 1.0,
                          matrix_residual: bool = False):
    """Population evaluation with the ENV AXIS SHARDED over a device mesh.

    The whole ARS population rollout — per-env policy matrices as
    data, MPC solves included — runs under `shard_map`, each device
    evaluating its shard of the population. The rollout body is per-env
    independent, so the hot path has zero collectives (same contract the
    dryrun asserts); the weight update on the host is the only global
    synchronization point — the multi-device deployment shape applied to
    the product training loop.

    Returns (sharded_rollout, carry0, w0): jitted
    rollout(carry, w_per_env) -> (carry, returns (B,)), the sharded
    initial carry, and a zero sharded policy batch.
    """
    from biped_pympc_tpu.parallel import mesh as pmesh

    act_dim = ACT_DIM_MATRIX if matrix_residual else ACT_DIM
    env_step, reset_all, rl_obs, core = make_device_env(
        num_envs, solver=solver, plant_mass_scale=plant_mass_scale,
        matrix_residual=matrix_residual)
    _apply_newton_iterations(core, newton_iterations)
    rollout = make_rollout(env_step, rl_obs, steps)

    sharded_rollout = _shard_rollout(mesh, rollout)
    carry0 = pmesh.shard_state(reset_all(), mesh)
    w0 = jax.device_put(
        jnp.zeros((num_envs, act_dim, OBS_DIM), jnp.float32),
        pmesh.batch_sharding(mesh))
    return sharded_rollout, carry0, w0


def train(iters: int = 10, n_dirs: int = 4, envs_per: int = 4,
          steps: int = 40, step_size: float = 0.02, noise: float = 0.05,
          solver: str = "auto", seed: int = 0,
          plant_mass_scale: float = 1.0, matrix_residual: bool = False,
          plant_force_scale=None, newton_iterations: int = 20,
          verbose: bool = True, emit=None, mesh=None):
    """ARS with antithetic directions, device-resident rollouts.

    Same estimator and batch layout as the host trainer
    (`train_rl_mpc.train`): env groups [dir0+, dir0-, dir1+, dir1-, ...] of
    `envs_per` envs each. Returns (W, history of mean returns).

    mesh: optional `jax.sharding.Mesh` — population evaluation sharded
    over its devices (`make_sharded_training`); None = single device.
    matrix_residual: grow the action space to 16 dims (B-matrix
    force/moment-effectiveness residuals, `rl_env_tpu.make_device_env`).
    plant_force_scale: (3,) per-axis plant GRF effectiveness — the
    structured input-dependent model error the matrix residuals exist for.
    """
    rng = np.random.default_rng(seed)
    num_envs = 2 * n_dirs * envs_per
    act_dim = ACT_DIM_MATRIX if matrix_residual else ACT_DIM
    env_kw = dict(solver=solver, plant_mass_scale=plant_mass_scale,
                  matrix_residual=matrix_residual,
                  plant_force_scale=plant_force_scale)
    env_step, reset_all, rl_obs, core = make_device_env(num_envs, **env_kw)
    # 10 iterations is a closed-loop-viable HECTOR setting.
    _apply_newton_iterations(core, newton_iterations)
    rollout_fn = make_rollout(env_step, rl_obs, steps)
    if mesh is not None:
        from biped_pympc_tpu.parallel import mesh as pmesh

        rollout = _shard_rollout(mesh, rollout_fn)
        _shard = lambda t: pmesh.shard_state(t, mesh)
    else:
        rollout = rollout_fn
        _shard = lambda t: t

    w = np.zeros((act_dim, OBS_DIM))
    history = []
    env_steps_per_rollout = num_envs * steps * core.mpc_cfg.decimation
    t_rollouts = []

    for it in range(iters):
        deltas = rng.standard_normal((n_dirs, act_dim, OBS_DIM))
        w_per_env = np.empty((num_envs, act_dim, OBS_DIM), np.float32)
        for d in range(n_dirs):
            base = 2 * d * envs_per
            w_per_env[base: base + envs_per] = w + noise * deltas[d]
            w_per_env[base + envs_per: base + 2 * envs_per] = \
                w - noise * deltas[d]

        carry = _shard(reset_all())
        t0 = time.perf_counter()
        carry, returns = jax.block_until_ready(
            rollout(carry, _shard(jnp.asarray(w_per_env))))
        dt_s = time.perf_counter() - t0
        if it > 0:  # it 0 pays the compile
            t_rollouts.append(dt_s)
        returns = np.asarray(returns, np.float64)

        grouped = returns.reshape(2 * n_dirs, envs_per).mean(axis=1)
        r_plus, r_minus = grouped[0::2], grouped[1::2]
        sigma = np.concatenate([r_plus, r_minus]).std() + 1e-8
        grad = np.einsum("d,dao->ao", r_plus - r_minus, deltas) / n_dirs
        w = w + step_size / sigma * grad
        history.append(float(returns.mean()))
        if verbose:
            rate = env_steps_per_rollout / dt_s
            print(f"iter {it:3d}  mean return {history[-1]:8.3f}  "
                  f"rollout {1e3 * dt_s:7.1f} ms  "
                  f"({rate / 1e3:.0f}k env-steps/s)", flush=True)
        if emit is not None:
            emit({"iter": it, "mean_return": round(history[-1], 4),
                  "rollout_s": round(dt_s, 3)})

    stats = {}
    if t_rollouts:
        t_med = float(np.median(t_rollouts))
        stats = {
            "env_steps_per_s": round(env_steps_per_rollout / t_med, 0),
            "rollout_ms_p50": round(1e3 * t_med, 1),
            "num_envs": num_envs, "steps": steps,
        }
    return w, history, stats


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dirs", type=int, default=4)
    p.add_argument("--envs-per", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--solver", default="auto")
    p.add_argument("--mass-error", type=float, default=1.0,
                   help="plant mass scale (model-error compensation task: "
                        "the policy must learn SRBD residuals that close "
                        "the MPC-vs-plant gap)")
    p.add_argument("--matrix-residual", action="store_true",
                   help="16-dim action space incl. B-matrix force/moment-"
                        "effectiveness residuals (set_srbd_residual)")
    p.add_argument("--force-error", type=float, default=1.0,
                   help="plant z-axis GRF effectiveness (e.g. 0.7: only "
                        "70%% of commanded vertical force is delivered — "
                        "an input-proportional model error the constant "
                        "accel residuals cannot represent)")
    p.add_argument("--newton-iters", type=int, default=20,
                   help="PDIPM iterations (10 is closed-loop viable for "
                        "HECTOR)")
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--step-size", type=float, default=0.02)
    p.add_argument("--bench", action="store_true",
                   help="append artifact to results/train_rl_mpc_tpu.jsonl")
    p.add_argument("--mesh", action="store_true",
                   help="shard the population evaluation over all local "
                        "devices (parallel/mesh.py; 1-device mesh on a "
                        "single chip exercises the same sharded program)")
    args = p.parse_args()

    emit = None
    if args.bench:
        sys.path.insert(0, "bench")
        from bench_common import make_emitter
        emit = make_emitter("train_rl_mpc_tpu", vars(args))

    mesh = None
    if args.mesh:
        from biped_pympc_tpu.parallel import mesh as pmesh
        mesh = pmesh.make_mesh()
        print(f"sharding population over {len(jax.devices())} device(s)")
    force_scale = None
    if args.force_error != 1.0:
        force_scale = (1.0, 1.0, args.force_error)
    w, history, stats = train(
        iters=args.iters, n_dirs=args.dirs, envs_per=args.envs_per,
        steps=args.steps, solver=args.solver, emit=emit,
        plant_mass_scale=args.mass_error, noise=args.noise,
        step_size=args.step_size, mesh=mesh,
        matrix_residual=args.matrix_residual,
        plant_force_scale=force_scale,
        newton_iterations=args.newton_iters)
    print(f"\nreturn: first {history[0]:.3f} -> last {history[-1]:.3f} "
          f"(best {max(history):.3f})")
    print(f"policy norm {np.linalg.norm(w):.4f}")
    if stats:
        print(f"throughput: {stats['env_steps_per_s']:.0f} env-steps/s "
              f"at {stats['num_envs']} envs")
        if emit is not None:
            emit({"summary": stats,
                  "return_first": round(history[0], 3),
                  "return_last": round(history[-1], 3),
                  "return_best": round(max(history), 3)})


if __name__ == "__main__":
    main()
