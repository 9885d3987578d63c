"""Long-horizon closed-loop stability: 256 envs x 30 s sim.

The f32 solver drives the full walking loop (100 Hz MPC, 1 kHz
control + SRBD plant) for 30,000 ticks in 30 x 1 s dispatches; reports the
fraction of envs upright (height within 0.15 m of command, |rp| < 0.5 rad)
and tracking stats along the way. Commands are domain-randomized per env
(vx in [-0.3, 0.5], vy in [-0.15, 0.15], wz in [-0.3, 0.3], random gait
phases) — the RL-training batch shape.

Flags: --yaw (omnidirectional contact frame), --solver NAME (default
"auto"), --robot NAME ("T1" / "T1-newton" run the 0.62 m,
f_max=1450 N T1 configuration and append to results/t1_rollout.jsonl
instead), --obs-ik newton (exact-IK encoder stand-in for plain T1; see
closed_loop_sim.simulate), --iters N (Newton iterations). Appends
results/ab_stability.jsonl; every record file starts with the device it
ran on.
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]

import json, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "examples"))
from tpu_rollout import init_carry, make_rollout
from biped_pympc_tpu.control.controller import BipedControllerCore
from biped_pympc_tpu import ControllerConf, MPCConf
from biped_pympc_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()

batch = 256
import sys as _sys
frame = "yaw" if "--yaw" in _sys.argv else "world"
solver = "auto"
if "--solver" in _sys.argv:
    solver = _sys.argv[_sys.argv.index("--solver") + 1]
robot = "HECTOR"
if "--robot" in _sys.argv:
    robot = _sys.argv[_sys.argv.index("--robot") + 1]
obs_ik = "robot"
if "--obs-ik" in _sys.argv:
    obs_ik = _sys.argv[_sys.argv.index("--obs-ik") + 1]
iters = 20
if "--iters" in _sys.argv:  # reduced-iteration closed-loop study
    iters = int(_sys.argv[_sys.argv.index("--iters") + 1])
height = 0.55 if robot == "HECTOR" else 0.62
f_max = 500.0 if robot == "HECTOR" else 1450.0
# T1 runs its tuned configuration (real foot levers via RobotSpec.lt/lh +
# the ab_t1_tune.py-measured gait: ssp=9, dsp=2, swing 0.12) unless
# --reference-constants asks for the reference's HECTOR constants.
if robot != "HECTOR" and "--reference-constants" not in _sys.argv:
    from biped_pympc_tpu.config import recommended_conf
    cconf, mpc_kw = recommended_conf(robot)  # the documented usage path
    mpc_kw.update(solver=solver, contact_frame=frame,
                  newton_iterations=iters)
else:
    cconf = ControllerConf()
    mpc_kw = dict(solver=solver, contact_frame=frame, robot=robot,
                  f_max=f_max, newton_iterations=iters)
core = BipedControllerCore(cconf, MPCConf(**mpc_kw), gait_id=2)
from bench_common import make_emitter
emit = make_emitter("ab_stability" if robot == "HECTOR" else "t1_rollout",
                    {"frame": frame, "solver": core.solver, "robot": robot,
                     "obs_ik": obs_ik, "iters": iters})
rollout, cycles = make_rollout(core, 1.0, obs_ik=obs_ik)
rollout = jax.jit(rollout)
carry = init_carry(core, batch, 0.3, height)
# Domain-randomize: per-env twist command and gait phase.
rng = np.random.default_rng(0)
state, x, foot_w = carry
twist = np.zeros((batch, 3), np.float32)
twist[:, 0] = rng.uniform(-0.3, 0.5, batch)
twist[:, 1] = rng.uniform(-0.15, 0.15, batch)
twist[:, 2] = rng.uniform(-0.3, 0.3, batch)
state = core.set_command(state, jnp.asarray(twist),
                         jnp.full((batch,), height, jnp.float32))
state = state._replace(
    gait_phase=jnp.asarray(rng.uniform(0, 1, batch).astype(np.float32)))
if "--reference-constants" in _sys.argv:
    # Replication mode: the reference's hardcoded HECTOR levers.
    state = state._replace(lt=jnp.full((batch,), 0.07, jnp.float32),
                           lh=jnp.full((batch,), 0.04, jnp.float32))
    emit({"note": "reference-constants mode: lt/lh forced to 0.07/0.04"})
carry = (state, x, foot_w)
cmd_vx = twist[:, 0]
for sec in range(30):
    carry, traj = rollout(carry)
    if sec in (0, 4, 9, 19, 29):
        x = np.asarray(carry[1])  # (B, 12): [rpy, pos, w, v]
        h = x[:, 5]; rp = np.abs(x[:, 0:2]).max(axis=1)
        vx = x[:, 9]
        upright = (np.abs(h - height) < 0.15) & (rp < 0.5) & np.isfinite(x).all(axis=1)
        vx_err = np.abs(vx - cmd_vx)
        # Stats over the finite envs (nanmedian etc.) so a diverged env
        # doesn't blank the whole row; divergence is counted in nan_envs.
        emit({"sim_s": sec+1,
            "upright_frac": round(float(upright.mean()), 4),
            "height_p50": round(float(np.nanmedian(h)), 4),
            "height_p5": round(float(np.nanpercentile(h, 5)), 4),
            "vx_err_p50": round(float(np.nanmedian(vx_err)), 3),
            "vx_err_p95": round(float(np.nanpercentile(vx_err, 95)), 3),
            "nan_envs": int((~np.isfinite(x).all(axis=1)).sum())})
