"""T1 tuning sweep: one compiled rollout, grid as per-env data.

Closes the T1 quality gap. Every knob named as the limiter — toe/heel
lever arms, gait timing
(ssp/dsp), swing height — is PER-ENV DATA in this framework (the reference
bakes all of them into its compiled CUDA kernel), so the whole tuning grid
runs as one batched rollout: n_cfg configs x n_seed randomized commands,
one compile, one dispatch per simulated second.

Grid: levers {HECTOR 0.07/0.04, T1-URDF 0.1215/0.1015} x ssp {5,7,9} x
dsp {0,2} x swing_height {0.08, 0.12} = 24 configs x 16 seeds = 384 envs,
10 s sim each. Appends results/t1_tune.jsonl (one row per config, after a
header naming the device).

Usage: python bench/ab_t1_tune.py [--seconds 10] [--seeds 16]
"""
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]
_sys.path.insert(0, _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "examples"))

import itertools

import numpy as np
import jax
import jax.numpy as jnp

from tpu_rollout import init_carry, make_rollout
from biped_pympc_tpu import ControllerConf, MPCConf
from biped_pympc_tpu.control import gait
from biped_pympc_tpu.control.controller import BipedControllerCore
from biped_pympc_tpu.utils.cache import enable_compilation_cache
from bench_common import make_emitter

enable_compilation_cache()

seconds = 10
if "--seconds" in _sys.argv:
    seconds = int(_sys.argv[_sys.argv.index("--seconds") + 1])
n_seed = 16
if "--seeds" in _sys.argv:
    n_seed = int(_sys.argv[_sys.argv.index("--seeds") + 1])
solver = "auto"
if "--solver" in _sys.argv:
    solver = _sys.argv[_sys.argv.index("--solver") + 1]

HEIGHT = 0.62
LEVERS = {"hector": (0.07, 0.04), "t1": (0.1215, 0.1015)}
GRID = list(itertools.product(
    LEVERS.items(),          # lever name, (lt, lh)
    (5, 7, 9),               # ssp MPC steps
    (0, 2),                  # dsp MPC steps
    (0.08, 0.12),            # swing height [m]
))
n_cfg = len(GRID)
batch = n_cfg * n_seed
print(f"{n_cfg} configs x {n_seed} seeds = {batch} envs, {seconds} s")

core = BipedControllerCore(
    ControllerConf(),
    MPCConf(solver=solver, contact_frame="yaw", robot="T1", f_max=1450.0,
            verbose=False),
    gait_id=2,
)
emit = make_emitter("t1_tune", {"solver": core.solver, "seconds": seconds,
                                "seeds": n_seed})

rollout, cycles = make_rollout(core, 1.0)
rollout = jax.jit(rollout)
carry = init_carry(core, batch, 0.3, HEIGHT)
state, x, foot_w = carry

# Per-env config columns (config-major: env = cfg * n_seed + seed).
lt = np.empty(batch, np.float32); lh = np.empty(batch, np.float32)
ssp = np.empty(batch, np.int32); dsp = np.empty(batch, np.int32)
swing_h = np.empty(batch, np.float32)
for c, ((lname, (clt, clh)), cssp, cdsp, csw) in enumerate(GRID):
    sl = slice(c * n_seed, (c + 1) * n_seed)
    lt[sl], lh[sl], ssp[sl], dsp[sl], swing_h[sl] = clt, clh, cssp, cdsp, csw

# Randomized commands, shared across configs (seed-major within config).
rng = np.random.default_rng(0)
twist_seed = np.zeros((n_seed, 3), np.float32)
twist_seed[:, 0] = rng.uniform(-0.3, 0.5, n_seed)
twist_seed[:, 1] = rng.uniform(-0.15, 0.15, n_seed)
twist_seed[:, 2] = rng.uniform(-0.3, 0.3, n_seed)
phase_seed = rng.uniform(0, 1, n_seed).astype(np.float32)
twist = np.tile(twist_seed, (n_cfg, 1))
phase = np.tile(phase_seed, n_cfg)

state = core.set_command(state, jnp.asarray(twist),
                         jnp.full((batch,), HEIGHT, jnp.float32))
gp = gait.GaitParams(
    dsp_steps=jnp.asarray(np.stack([dsp, dsp], 1)),
    ssp_steps=jnp.asarray(np.stack([ssp, ssp], 1)),
)
state = state._replace(
    gait_phase=jnp.asarray(phase),
    gait_params=gp,
    lt=jnp.asarray(lt), lh=jnp.asarray(lh),
    foot_height=jnp.asarray(swing_h),
)
# swing_time_remaining must match the new per-env gait (init_state set it
# from the default ControllerConf gait).
swing_dur = jax.vmap(gait.swing_duration_sec)(gp, state.dt_mpc)
state = state._replace(
    swing_state=state.swing_state._replace(swing_time_remaining=swing_dur))
carry = (state, x, foot_w)

for sec in range(seconds):
    carry, _ = rollout(carry)
xf = np.asarray(carry[1])  # (B, 12)

h = xf[:, 5]; rp = np.abs(xf[:, 0:2]).max(axis=1); vx = xf[:, 9]
upright = (np.abs(h - HEIGHT) < 0.15) & (rp < 0.5) & np.isfinite(xf).all(axis=1)
vx_err = np.abs(vx - twist[:, 0])
h_err = np.abs(h - HEIGHT)

rows = []
for c, ((lname, (clt, clh)), cssp, cdsp, csw) in enumerate(GRID):
    sl = slice(c * n_seed, (c + 1) * n_seed)
    row = {
        "levers": lname, "ssp": cssp, "dsp": cdsp, "swing_h": csw,
        "upright_frac": round(float(upright[sl].mean()), 4),
        "height_p50": round(float(np.nanmedian(h[sl])), 4),
        "height_err_p50": round(float(np.nanmedian(h_err[sl])), 4),
        "vx_err_p50": round(float(np.nanmedian(vx_err[sl])), 3),
        "vx_err_p95": round(float(np.nanpercentile(vx_err[sl], 95)), 3),
        "nan_envs": int((~np.isfinite(xf[sl]).all(axis=1)).sum()),
    }
    rows.append(row)
    emit(row)

rows.sort(key=lambda r: (-r["upright_frac"], r["vx_err_p50"] + 3 * r["height_err_p50"]))
print("\ntop 8 configs:")
for r in rows[:8]:
    print(r)
