"""Smoke test of the batched MPC main path on one NVIDIA GPU.

Drives the HECTOR walking controller at full width (batch 4096, horizon 10,
20 Newton iterations, float32) through the entry points a user calls and
checks what comes out. Phases, each printing one JSON line that names the
card:

  card           nvidia-smi name and power limit, JAX device
  build          the fused solver's CUDA library (set-up time)
  controller     a few hundred ticks of the `MPCController` loop; every
                 torque and GRF finite
  accuracy       f32 GRFs of both solver ends against the f64 golden:
                 converged problem (<= 0.05 N), 8 stress problems (target
                 <= 1 N), 32 randomized envs of a b4096 batch; no
                 non-finite value; then both ends env for env over the
                 whole b4096 batch, the 16 envs where they disagree most
                 against the golden at 20 iterations and at convergence
  accuracy_f64   plain ric_aug in float64 against the golden (median
                 < 3e-7, max < 1e-5)
  solver_timing  plain XLA ("ric_aug") vs fused CUDA ("fused_ric_aug") on
                 `run_mpc` and `control_step`, in turns (plain, fused,
                 fused, plain), each call ending in block_until_ready
  rollout        a few MPC cycles of the whole-rollout program
  ars            one ARS iteration of the on-device trainer (b4096)
  memory         peak device bytes in use

The controller, rollout and ARS phases run the solver `MPCConf.solver=
"auto"` resolves to (the fused kernel on a GPU). Compile times are reported
as set-up time. Any failure raises and exits
non-zero. The last line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Options:
  --rehearse    every phase at a tiny batch on the CPU (dry run); prints
                no ok line
  --four-cards  only the multi-card path: the env-batch-sharded
                `control_step` at b32768 over 4 GPUs against the same batch
                on one GPU, the zero-collective check on its compiled HLO,
                and the pmean metric

Run on the card:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--four-cards", action="store_true")
    return p.parse_args(argv)


class Smoke:
    def __init__(self, rehearse: bool):
        import jax

        from bench_common import card_info

        self.rehearse = rehearse
        self.dev = jax.devices()[0]
        self.card = card_info()
        self.batch = 64 if rehearse else 4096

    def emit(self, phase: str, **fields):
        print(json.dumps({"phase": phase, "card": self.card,
                          "device_kind": self.dev.device_kind, **fields}),
              flush=True)


def _walking_inputs(core, batch: int, seed: int = 0):
    """Domain-randomized walking obs / command for HECTOR."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    dof = core.num_dof
    obs = np.zeros((batch, 13 + 6 * dof), np.float32)
    obs[:, 2] = 0.55 + rng.uniform(-0.02, 0.02, batch)
    obs[:, 3] = 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], np.float32)
    obs[:, 13: 13 + dof] = q0 + rng.uniform(-0.05, 0.05, (batch, dof))
    obs[:, 13 + dof: 13 + 2 * dof] = q0
    twist = rng.uniform(-0.3, 0.3, (batch, 3)).astype(np.float32)
    height = np.full((batch,), 0.55, np.float32)
    phase = rng.uniform(0, 1, batch).astype(np.float32)
    return (jnp.asarray(obs), jnp.asarray(twist), jnp.asarray(height),
            jnp.asarray(phase))


def _ready_state(core, batch: int, seed: int = 0):
    """A walking controller state mid-gait, plus the tick inputs."""
    obs, twist, height, phase = _walking_inputs(core, batch, seed)
    state = core.init_state(batch)
    state = core.set_command(state, twist, height)
    state = core.ingest_state(state, obs)
    return state._replace(gait_phase=phase), (obs, twist, height)


def _check(ok: bool, what: str) -> None:
    """Fail the smoke run (also under `python -O`, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _finite(*arrays) -> bool:
    import numpy as np

    return all(bool(np.isfinite(np.asarray(a)).all()) for a in arrays)


def phase_build(sm: Smoke):
    from biped_pympc_tpu.ops import pdipm_fused

    t0 = time.perf_counter()
    lib = pdipm_fused.build_library("cpu" if sm.rehearse else "cuda")
    sm.emit("build", setup_s=time.perf_counter() - t0,
            library=os.path.basename(lib))


def phase_controller(sm: Smoke, ticks: int):
    from biped_pympc_tpu import ControllerConf, MPCConf, MPCController

    ctrl = MPCController(ControllerConf(), MPCConf(verbose=False),
                         num_envs=sm.batch, gait_id=2)
    obs, twist, height, _ = _walking_inputs(ctrl.core, sm.batch)
    ctrl.set_command(twist, height)
    dec = ctrl.core.mpc_cfg.decimation

    def tick(k):
        ctrl.update_state(obs)
        if k % dec == 0:
            ctrl.run_mpc()
        ctrl.run_lowlevel()
        return ctrl.get_action()

    t0 = time.perf_counter()
    tau = tick(0).block_until_ready()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(1, ticks):
        tau = tick(k)
    tau.block_until_ready()
    loop_s = time.perf_counter() - t0
    ok = _finite(tau, ctrl.grf_world, ctrl.ground_reaction_wrench)
    sm.emit("controller", solver=ctrl.core.solver, batch=sm.batch, ticks=ticks,
            mpc_solves=(ticks + dec - 1) // dec, setup_s=setup_s,
            loop_s=loop_s, ms_per_tick=1e3 * loop_s / (ticks - 1),
            all_finite=ok)
    _check(ok, "non-finite torque or GRF in the controller loop")


def phase_accuracy(sm: Smoke):
    from ab_accuracy import (CONVERGED_BOUND_N, F64_MAX_BOUND,
                             F64_MEDIAN_BOUND, STRESS_TARGET_N,
                             f32_accuracy, f64_plain_vs_golden,
                             worst_disagreement)

    t0 = time.perf_counter()
    recs = f32_accuracy(("ric_aug", "fused_ric_aug"),
                        randomized_batch=sm.batch)
    stress_met = all(r["max_N"] <= STRESS_TARGET_N for r in recs
                     if r["set"] == "stress8")
    sm.emit("accuracy", records=recs, stress_target_N=STRESS_TARGET_N,
            stress_target_met=stress_met, wall_s=time.perf_counter() - t0)
    bad = [r for r in recs if r["nonfinite_envs"]]
    _check(not bad, f"non-finite GRFs: {bad}")
    conv = [r for r in recs if r["set"] == "converged"]
    _check(all(r["max_N"] <= CONVERGED_BOUND_N for r in conv),
           f"converged problem beyond {CONVERGED_BOUND_N} N: {conv}")

    t0 = time.perf_counter()
    worst = worst_disagreement(sm.batch, k=4 if sm.rehearse else 16)
    sm.emit("accuracy_disagreement", **worst,
            wall_s=time.perf_counter() - t0)
    bad = {n: r["nonfinite_envs"] for n, r in worst["solvers"].items()
           if r["nonfinite_envs"]}
    _check(not bad, f"non-finite GRFs in the full batch: {bad}")

    f64 = f64_plain_vs_golden()
    sm.emit("accuracy_f64", **f64, median_bound=F64_MEDIAN_BOUND,
            max_bound=F64_MAX_BOUND)
    _check(f64["median_abs"] < F64_MEDIAN_BOUND
           and f64["max_abs"] < F64_MAX_BOUND, f"f64 vs golden: {f64}")


def _median_call_s(fn, n: int) -> float:
    import numpy as np

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_solver_timing(sm: Smoke, calls: int):
    import jax

    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore

    ends = {}
    for solver in ("ric_aug", "fused_ric_aug"):
        core = BipedControllerCore(
            ControllerConf(), MPCConf(solver=solver, verbose=False),
            gait_id=2)
        state, (obs, twist, height) = _ready_state(core, sm.batch)
        run_mpc = lambda c=core, s=state: jax.block_until_ready(
            c.run_mpc(s))
        step = lambda c=core, s=state: jax.block_until_ready(
            c.control_step(s, obs, twist, height))
        setup = {}
        for name, fn in (("run_mpc", run_mpc), ("control_step", step)):
            t0 = time.perf_counter()
            out = fn()
            setup[name] = time.perf_counter() - t0
        _check(_finite(out[1], out[2].grf_world), f"non-finite {solver}")
        ends[solver] = {"run_mpc": run_mpc, "control_step": step,
                        "setup_s": setup}
    turns = {s: {"run_mpc": [], "control_step": []} for s in ends}
    for solver in ("ric_aug", "fused_ric_aug", "fused_ric_aug", "ric_aug"):
        for name in ("run_mpc", "control_step"):
            turns[solver][name].append(
                1e3 * _median_call_s(ends[solver][name], calls))
    mean = {s: {k: sum(v) / len(v) for k, v in t.items()}
            for s, t in turns.items()}
    faster = all(mean["fused_ric_aug"][k] < mean["ric_aug"][k]
                 for k in ("run_mpc", "control_step"))
    sm.emit("solver_timing", batch=sm.batch, horizon=10, iterations=20,
            calls_per_turn=calls, order="plain,fused,fused,plain",
            turns_ms=turns, mean_ms=mean,
            setup_s={s: e["setup_s"] for s, e in ends.items()},
            fused_faster_on_both=faster)


def phase_rollout(sm: Smoke, cycles: int):
    import jax
    import numpy as np

    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from tpu_rollout import init_carry, make_rollout

    core = BipedControllerCore(
        ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08),
        MPCConf(verbose=False), gait_id=2)
    seconds = cycles * core.mpc_cfg.decimation * core.mpc_cfg.dt
    rollout, n_cycles = make_rollout(core, seconds)
    carry = init_carry(core, sm.batch, 0.3, 0.55)
    t0 = time.perf_counter()
    jax.block_until_ready(rollout(carry))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, traj = jax.block_until_ready(rollout(carry))
    run_s = time.perf_counter() - t0
    traj = np.asarray(traj)
    env_steps = sm.batch * n_cycles * core.mpc_cfg.decimation
    ok = _finite(traj)
    sm.emit("rollout", solver=core.solver, batch=sm.batch, cycles=n_cycles,
            setup_s=setup_s, run_s=run_s, env_steps_per_s=env_steps / run_s,
            height_mean=float(traj[-1, :, 5].mean()), all_finite=ok)
    _check(ok, "non-finite rollout state")


def phase_ars(sm: Smoke):
    import jax.numpy as jnp
    import numpy as np

    from biped_pympc_tpu import MPCConf
    from biped_pympc_tpu.control.controller import resolve_solver
    from train_rl_mpc_tpu import train

    n_dirs, envs_per = (2, 16) if sm.rehearse else (16, 128)
    t0 = time.perf_counter()
    # Iteration 0 pays the compile; iteration 1 is the timed ARS step.
    w, history, stats = train(iters=2, n_dirs=n_dirs, envs_per=envs_per,
                              steps=3, verbose=False)
    ok = bool(np.isfinite(history).all() and np.isfinite(w).all())
    solver = resolve_solver(MPCConf(verbose=False), jnp.float32)
    sm.emit("ars", solver=solver, wall_s=time.perf_counter() - t0,
            returns=history, **stats, all_finite=ok)
    _check(ok, "non-finite ARS return or policy")


def phase_memory(sm: Smoke):
    stats = sm.dev.memory_stats() or {}
    sm.emit("memory", peak_bytes_in_use=stats.get("peak_bytes_in_use"))


def four_cards(sm: Smoke):
    """Sharded control_step over 4 devices vs the same batch on one."""
    import jax
    import numpy as np

    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.parallel import mesh as pmesh

    devices = jax.devices()
    _check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    batch = 64 if sm.rehearse else 32768
    core = BipedControllerCore(
        ControllerConf(), MPCConf(verbose=False), gait_id=2)
    state, (obs, twist, height) = _ready_state(core, batch)
    one = jax.device_put((state, obs, twist, height), devices[0])
    t0 = time.perf_counter()
    ref = jax.block_until_ready(core.control_step(*one))
    single_setup_s = time.perf_counter() - t0
    single_ms = 1e3 * _median_call_s(
        lambda: jax.block_until_ready(core.control_step(*one)), 5)

    mesh = pmesh.make_mesh(devices)
    put = lambda t: pmesh.shard_state(t, mesh)
    sharded_args = (put(state), put(obs), put(twist), put(height))
    step = pmesh.controller_step(core, mesh)
    t0 = time.perf_counter()
    n_coll = pmesh.count_collectives(
        step.lower(*sharded_args).compile().as_text())
    got = jax.block_until_ready(step(*sharded_args))
    sharded_setup_s = time.perf_counter() - t0
    sharded_ms = 1e3 * _median_call_s(
        lambda: jax.block_until_ready(step(*sharded_args)), 5)

    tau_ref, tau = np.asarray(ref[1]), np.asarray(got[1])
    grf_ref = np.asarray(ref[2].grf_world)
    grf = np.asarray(got[2].grf_world)
    d_tau = np.abs(tau - tau_ref).max(axis=1)
    d_grf = np.abs(grf - grf_ref).max(axis=1)

    metric = pmesh.shard_map_step(
        lambda st, o, tw, h: core.control_step(st, o, tw, h), mesh,
        with_metrics=True)
    mean_cost = float(jax.block_until_ready(metric(*sharded_args))[3])
    ref_cost = float(np.mean(np.asarray(ref[2].cost)))

    tol_n = 1e-3  # GRF [N] / torque [Nm], env for env
    sm.emit("four_cards", solver=core.solver, batch=batch,
            per_card=batch // 4, hot_path_collectives=n_coll,
            grf_max_abs_diff_N=float(d_grf.max()),
            grf_envs_over_tol=int((d_grf > tol_n).sum()),
            tau_max_abs_diff_Nm=float(d_tau.max()),
            tau_envs_over_tol=int((d_tau > tol_n).sum()), tol=tol_n,
            pmean_cost=mean_cost, single_card_mean_cost=ref_cost,
            single_card_ms=single_ms, sharded_ms=sharded_ms,
            setup_s={"single": single_setup_s, "sharded": sharded_setup_s},
            all_finite=_finite(tau, grf))
    _check(n_coll == 0, f"{n_coll} collectives in the hot-path step")
    _check(_finite(tau, grf), "non-finite sharded output")
    _check(bool((d_grf <= tol_n).all() and (d_tau <= tol_n).all()),
           "sharded step differs from one card")
    _check(abs(mean_cost - ref_cost) <= 1e-4 * max(1.0, abs(ref_cost)),
           f"pmean cost {mean_cost} vs one card {ref_cost}")


def main(argv=None) -> int:
    args = _args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_device_"
                                       "count=4").strip()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "bench"),
                    os.path.join(ROOT, "examples")]
    import jax

    import bench_common  # noqa: F401  (fails outside the repo)
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    if not args.rehearse and jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        return 1
    enable_compilation_cache()
    sm = Smoke(args.rehearse)
    print(sm.card or "no nvidia-smi", flush=True)
    sm.emit("card", platform=sm.dev.platform, count=len(jax.devices()))
    phase_build(sm)
    if args.four_cards:
        four_cards(sm)
    else:
        phase_controller(sm, ticks=20 if args.rehearse else 300)
        phase_accuracy(sm)
        phase_solver_timing(sm, calls=2 if args.rehearse else 5)
        phase_rollout(sm, cycles=3)
        phase_ars(sm)
        phase_memory(sm)
    if args.rehearse:
        print("rehearsal complete (no ok line off the GPU)", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": sm.dev.platform, "kind": sm.dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
