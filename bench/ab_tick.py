"""Stage-level timing of the 1 kHz rollout tick at batch 4096.

Times chained scans of: obs assembly (quat/rot/IK), controller ingest
(FK/J/gait), low-level (swing/Raibert/Bezier/leg IK), and plant RK4 — each
in isolation — to find where a rollout tick's time goes. Prints the device
it ran on first.
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]


import json
import sys
import time

import numpy as np

sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "examples"))


def main():
    import jax
    import jax.numpy as jnp

    from tpu_rollout import init_carry, make_rollout  # noqa: F401
    import tpu_rollout as tr

    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    chain = 100

    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    from bench_common import device_info

    print(json.dumps({"device": device_info()}), flush=True)
    core = BipedControllerCore(cfg, MPCConf(), gait_id=2)
    robot = core.robot
    state, x, foot_w = tr.init_carry(core, batch, 0.3, 0.55)

    # Rebuild the rollout's per-tick pieces (mirrors make_rollout).
    from biped_pympc_tpu.models import srbd
    from biped_pympc_tpu.utils.maths import quat_to_rotmat

    dof = robot.num_dof
    dt = core.mpc_cfg.dt
    lin_template = srbd.SrbdLin(
        rot_body=jnp.eye(3),
        inertia_world=jnp.asarray(robot.i_body, jnp.float32),
        body_pos=jnp.zeros(3),
        foot_pos=jnp.zeros((2, 3)),
        mass=jnp.asarray(robot.mass, jnp.float32),
        residual_lin_accel=jnp.zeros(3),
        residual_ang_accel=jnp.zeros(3),
    )

    def assemble_obs(x, foot_w):
        def one(xi, feet):
            quat = tr._quat_from_euler(xi[:3])
            rot = quat_to_rotmat(quat)
            v_b = rot.T @ xi[9:12]
            w_b = rot.T @ xi[6:9]
            foot_b = (feet - xi[3:6]) @ rot
            q_l = robot.analytical_ik(foot_b[0], 0)
            q_r = robot.analytical_ik(foot_b[1], 1)
            return jnp.concatenate([
                xi[3:6], quat, v_b, w_b, q_l, q_r,
                jnp.zeros(4 * dof, xi.dtype),
            ]), rot
        return jax.vmap(one)(x, foot_w)

    obs0, rot0 = jax.jit(assemble_obs)(x, foot_w)
    state0 = core.ingest_state(state, obs0)
    grf0 = jnp.zeros((batch, 12), jnp.float32)

    def plant_only(x, foot_w):
        def one(xi, ui, feet):
            rot = quat_to_rotmat(tr._quat_from_euler(xi[:3]))
            lin = lin_template._replace(
                rot_body=rot,
                inertia_world=rot @ lin_template.inertia_world @ rot.T,
                body_pos=xi[3:6], foot_pos=feet,
            )
            return srbd.rk4_step_generic(lin, xi, ui, dt)
        return jax.vmap(one)(x, grf0, foot_w)

    # ingest: chain through gait_phase to serialize
    @jax.jit
    def ingest_chain(st, obs):
        def body(c, _):
            st2 = core.ingest_state(c, obs)
            st2 = st2._replace(gait_phase=st2.gait_phase
                               + 1e-12 * st2.leg_data.q[:, 0, 0])
            return st2, None
        out, _ = jax.lax.scan(body, st, None, length=chain)
        return out.gait_phase.sum()

    @jax.jit
    def lowlevel_chain(st):
        def body(c, _):
            st2 = core.run_lowlevel(c)
            st2 = st2._replace(gait_phase=st2.gait_phase
                               + 1e-12 * st2.leg_cmd.tau_ff[:, 0, 0])
            return st2, None
        out, _ = jax.lax.scan(body, st, None, length=chain)
        return out.gait_phase.sum()

    @jax.jit
    def obs_chain(x0):
        def body(c, _):
            obs, _ = assemble_obs(c, foot_w)
            return c + 1e-12 * obs[:, :12], None
        out, _ = jax.lax.scan(body, x0, None, length=chain)
        return out.sum()

    @jax.jit
    def plant_chain(x0):
        def body(c, _):
            return plant_only(c, foot_w), None
        out, _ = jax.lax.scan(body, x0, None, length=chain)
        return out.sum()

    fns = {
        "obs(quat/rot/IK)": lambda: obs_chain(x),
        "ingest(FK/J/gait)": lambda: ingest_chain(state0, obs0),
        "lowlevel(swing/IK)": lambda: lowlevel_chain(state0),
        "plant(RK4)": lambda: plant_chain(x),
    }
    for f in fns.values():
        np.asarray(f())  # compile
    times = {n: [] for n in fns}
    for _ in range(4):
        for n, f in fns.items():
            t0 = time.perf_counter()
            np.asarray(f())
            times[n].append((time.perf_counter() - t0) / chain)
    out = {"batch": batch}
    for n, ts in times.items():
        out[n + "_ms"] = round(1e3 * float(np.median(ts)), 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
