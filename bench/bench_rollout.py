"""RL-training rollout throughput: env-steps/s per device, whole rollout on
device.

The reference's deployment shape is an RL trainer stepping thousands of MPC
controllers at 1 kHz with one CUDA launch per kernel per tick. Here the
entire closed loop (100 Hz MPC + 1 kHz low-level control + SRBD plant
physics) compiles into ONE device program (`examples/tpu_rollout.py`), so a
full rollout is a single dispatch.

Prints one JSON line per batch: 1 kHz env-steps/s and MPC solves/s.

Usage: python bench_rollout.py [--batches 1024,4096] [--seconds 0.5]
"""
# Runnable from anywhere: put the repo root (one level up) on sys.path
# so `import biped_pympc_tpu` and `import bench_common` both resolve.
import os as _os
import sys as _sys
_sys.path[:0] = [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                 _os.path.dirname(_os.path.abspath(__file__))]


import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="1024,4096")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--solver", default="auto",
                   help="MPCConf.solver")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--iters", type=int, default=20,
                   help="Newton iterations (10 is closed-loop viable for "
                        "HECTOR)")
    args = p.parse_args()

    import sys

    sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "examples"))
    from tpu_rollout import init_carry, make_rollout

    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from bench_common import make_emitter

    emit = make_emitter("bench_rollout", vars(args))
    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)

    for batch in [int(b) for b in args.batches.split(",")]:
        core = BipedControllerCore(
            cfg, MPCConf(solver=args.solver, verbose=False,
                         newton_iterations=args.iters), gait_id=2
        )
        rollout, cycles = make_rollout(core, args.seconds)
        carry = init_carry(core, batch, 0.3, 0.55)

        t0 = time.perf_counter()
        (state, x, _), traj = rollout(carry)
        np.asarray(x)
        compile_s = time.perf_counter() - t0

        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            (_, x, _), _ = rollout(carry)
            np.asarray(x)
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))

        ticks = cycles * core.mpc_cfg.decimation
        # Sanity: the batch must still be walking, not NaN-coasting.
        zs = np.asarray(traj)[-1, :, 5]
        assert np.isfinite(np.asarray(x)).all() and (np.abs(zs - 0.55) < 0.1).all()
        emit({
            "batch": batch, "solver": core.solver,
            "env_steps_per_sec": batch * ticks / t,
            "mpc_solves_per_sec": batch * cycles / t,
            "rollout_ticks": ticks,
            "wall_s_per_rollout": t,
            "realtime_factor_per_env": ticks * 1e-3 / t,
            "compile_s": compile_s,
        })


if __name__ == "__main__":
    main()
