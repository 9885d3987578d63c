"""Configuration dataclasses.

Mirrors the reference's `ControllerConf` / `MPCConf`
(`/root/reference/biped_pympc/configuration/configuration.py:6-70`) with
jax-friendly, hashable (static) fields. Weight vectors are tuples so config
objects can be closed over by jitted functions.

Note on Q: the reference's default Q carries 13 entries, a leftover from the
deprecated 13-state (gravity-augmented) formulation in
`utils/dynamics_utils.py`; its QP consumes only the first 12
(`srbd_constraints.py:54`, num_x = 12). We accept 13 and truncate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Tuple

_DEFAULT_Q = (150.0, 150.0, 250.0, 100.0, 100.0, 250.0, 1.0, 1.0, 5.0, 10.0, 10.0, 1.0)
_DEFAULT_R = (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4)


@dataclass(frozen=True)
class ControllerConf:
    """(`configuration.py:6-20`)."""

    ssp_durations: int = 5
    dsp_durations: int = 0
    swing_height: float = 0.1
    swing_reference_frame: Literal["world", "base"] = "base"
    # Swing curve type (`swing_leg_trajectory.py:8` curve_type)
    swing_curve: Literal["bezier", "cycloid"] = "bezier"


def recommended_conf(robot: str = "HECTOR"):
    """(ControllerConf, MPCConf kwargs) tuned per robot, closed-loop measured.

    The reference ships one set of gait/contact constants sized for HECTOR
    and applies them to every robot (`configuration.py:6-20`,
    `srbd_constraints.py:31,161-162`). A closed-loop sweep
    (`bench/ab_t1_tune.py`: 24 configs x 16 randomized commands as ONE
    batched rollout) measured the 40 kg T1's tuned gait: longer swing (ssp=9 vs 5 MPC steps), a short double-support
    phase (dsp=2), higher swing apex (0.12 m), plus its real foot levers
    (RobotSpec.lt/lh, on by default) and f_max=1450 N — taking the 10 s
    randomized protocol from 59% upright / 6 cm height error
    (reference-constants configuration) to 100% upright / 0.8 cm.

    Returns (ControllerConf, mpc_kwargs). The dict already contains the
    robot name — apply it as `MPCConf(**mpc_kwargs)` (optionally with
    further overrides NOT already in the dict):

        cconf, kw = recommended_conf("T1")
        ctrl = MPCController(cconf, MPCConf(**kw), num_envs, gait_id=2)
    """
    if robot.startswith("T1"):
        return (
            ControllerConf(ssp_durations=9, dsp_durations=2,
                           swing_height=0.12),
            {"robot": robot, "f_max": 1450.0, "contact_frame": "yaw"},
        )
    return ControllerConf(), {"robot": robot, "contact_frame": "yaw"}


@dataclass(frozen=True)
class MPCConf:
    """(`configuration.py:22-57`)."""

    dt: float = 0.001
    dt_mpc: float = 0.025
    horizon_length: int = 10
    decimation: int = 10
    Q: Tuple[float, ...] = _DEFAULT_Q
    R: Tuple[float, ...] = _DEFAULT_R
    # "ric_aug": the two-level augmented backend — same f32-robust accuracy
    # class as "tridiag_aug" (f64 golden parity ~2e-8) at a fraction of the
    # factorization work; pure JAX, compiled by XLA for any device and
    # dtype. It is the reference the fused solver is checked against.
    # "fused_ric_aug" runs the same algorithm (foot-split, one refinement
    # step) as one fused native kernel per solve: CUDA on a GPU, C++ on the
    # CPU (`ops/pdipm_fused.py`). It supports exactly that configuration in
    # float32 and raises for any other option.
    # "auto" (default) picks "fused_ric_aug" where it was measured faster —
    # a GPU, float32, fixed iterations, the kernel's options — and
    # "ric_aug" everywhere else (`controller.resolve_solver`).
    solver: Literal[
        "auto", "tridiag_aug", "tridiag", "dense", "ric", "ric_aug",
        "fused_ric_aug",
    ] = "auto"
    robot: Literal["HECTOR", "T1", "T1-newton"] = "HECTOR"
    # Solver knobs (reference constants: `sparse_pdipm_solver.py`,
    # `mpc_controller_cusadi.py:28,144`).
    newton_iterations: int = 20
    solver_beta: float = 1e-8
    solver_delta: float = 1e-8
    # Per-foot vertical-force cap [N]. The reference hardcodes 500 inside the
    # symbolic QP (`srbd_constraints.py:31`; changing it there forces a
    # multi-hour CUDA recompile). 500 N suits the 13.9 kg HECTOR (~3.7x mg);
    # for the 40 kg T1 (mg = 392 N) set ~800-1500 N or height tracking
    # saturates.
    f_max: float = 500.0
    solver_refine_steps: int = 1
    # Foot-split stage factorization ("ric"/"ric_aug" backends): the stage
    # [u, nu] / [u, z, nu] blocks decompose EXACTLY by foot (no cost term,
    # friction/line-contact row, or Mx selector couples foot L's inputs to
    # foot R's — only the dynamics do, and those live in the y-chain), so
    # the per-stage inverses shrink from one 14-/30-wide elimination to two
    # 4-/12-wide ones (~21x / ~7.8x fewer factor flops) with bitwise-
    # identical f64 results (`tests/test_pdipm.py::test_foot_split_exactness`).
    # Default ON; set False for the dense cross-check factorization. NOTE: on
    # the CONDENSED "ric" backend the split widens the worst-case f32 stress
    # tail; the shipped default pairs the split with the augmented backend,
    # where it is accuracy-neutral.
    solver_foot_split: bool = True
    # Adaptive iterations (opt-in, NOT strict reference parity): when > 0,
    # run the solver in `adaptive_chunk`-step launches inside a
    # `lax.while_loop` and stop early once EVERY env's residual criterion
    # max(||rx||, ||rs||, ||re||, mu) is below this tolerance (or at the
    # `newton_iterations` cap). Mirrors the reference's own outer loop over
    # fused 5-iteration launches (`mpc_controller_cusadi.py:144-169`) with
    # a data-dependent stop. 0 = fixed-iteration reference behavior.
    # Caveat: one stop decision gates the whole batch, and on realistic
    # batches the worst env's stationarity residual stays O(10) N at the
    # cap, so the stop never fires and the chunked launches cost extra.
    # Useful only for homogeneous well-conditioned workloads with a
    # calibrated tol.
    adaptive_tol: float = 0.0
    adaptive_chunk: int = 5
    # Jacobi KKT equilibration of the per-stage factorizations ("ric"/
    # "ric_aug" families): the stage blocks are congruence-scaled to ~unit
    # diagonal before elimination and unscaled after (K^-1 = D (D K D)^-1 D,
    # exact). Pure factorization preconditioning — iterates are
    # algebraically the reference's at every step; only f32 rounding
    # changes. Accuracy-neutral on the robust default and not a substitute
    # for refinement; default "none".
    solver_kkt_scale: Literal["none", "jacobi"] = "none"
    # Euler-rate convention; see `models/srbd.py` docstring. "rt_omega"
    # matches the shipped CUDA path, "r_omega" the CPU CasADi source.
    euler_rate_mode: Literal["rt_omega", "r_omega"] = "rt_omega"
    # Contact-constraint frame. "world" = reference parity: the QP's Mx=0
    # equality and toe/heel line-contact rows are fixed world-axis-aligned
    # (`srbd_constraints.py:144-227`), valid only near yaw = 0 (mod pi) —
    # at yaw ~ pi/2 the QP forbids the ankle pitch moment entirely and the
    # robot falls (measured: every env with |wz| >~ 0.1 rad/s dies once yaw
    # passes ~1.2 rad). "yaw" expresses u in yaw-aligned axes (constraint
    # rows stay constant; Bd columns rotate at assembly, the solution
    # rotates back at postprocess) and wraps the yaw tracking error — the
    # omnidirectional mode the reference lacks; turning works at any
    # heading. See `tests/test_controller.py::test_yaw_rotational_invariance`.
    contact_frame: Literal["world", "yaw"] = "world"
    print_solve_time: bool = False
    # Init-time config dump, parity with `configuration.py:59-70` (the
    # reference prints unconditionally at dataclass creation). Set False to
    # silence (e.g. when constructing many configs programmatically).
    verbose: bool = True

    def __post_init__(self):
        if len(self.Q) == 13:  # tolerate the reference's 13-entry default
            object.__setattr__(self, "Q", tuple(self.Q[:12]))
        assert len(self.Q) == 12, f"Q must have 12 weights, got {len(self.Q)}"
        assert len(self.R) == 12, f"R must have 12 weights, got {len(self.R)}"
        if self.verbose:
            print("[INFO] MPC Configuration:")
            print("+--------------------------------+")
            print(f"  dt: {self.dt}")
            print(f"  dt_mpc: {self.dt_mpc}")
            print(f"  horizon_length: {self.horizon_length}")
            print(f"  decimation: {self.decimation}")
            print(f"  Q: {self.Q}")
            print(f"  R: {self.R}")
            print(f"  solver: {self.solver}")
            print(f"  robot: {self.robot}")
            print("+--------------------------------+")
