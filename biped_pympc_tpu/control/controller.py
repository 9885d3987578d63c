"""Biped controller: the full control stack as batched pure functions.

Functional re-expression of the reference's `BipedController` orchestration
(`/root/reference/biped_pympc/biped_controller.py:13-179`): every mutable
buffer of the reference becomes a field of an explicit `ControllerState`
pytree with a leading env-batch axis; `reset(env_ids)` becomes a masked
`jnp.where`; the per-tick entry points are jit-able pure functions

    ingest_state :  (state, obs) -> state          (`update_state`, 1 kHz)
    run_mpc      :  state -> (state, MpcOutput)    (100 Hz)
    run_lowlevel :  state -> state                 (1 kHz)
    joint_torque :  state -> (B, 2*dof)            (`command_joint_torque`)

Everything is written single-env in the submodules and vmapped here; the
batch axis is the axis that shards across the device mesh (`parallel/mesh.py`).
Every jitted step traces its float32 matrix products at full precision
(`_step`), so no backend may run them in a reduced-precision mode such as
TF32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from biped_pympc_tpu.config import ControllerConf, MPCConf
from biped_pympc_tpu.control import estimator, gait, legs, mpc, swing
from biped_pympc_tpu.models.robot import RobotSpec, get_robot
from biped_pympc_tpu.ops import pdipm
from biped_pympc_tpu.ops.pdipm import PdipmOptions

SOLVERS = ("tridiag_aug", "tridiag", "dense", "ric", "ric_aug",
           "fused_ric_aug")
# Removed Pallas solver names -> their replacement.
_REMOVED_SOLVERS = {
    "pallas": "tridiag", "pallas_aug": "tridiag_aug", "pallas_ric": "ric",
    "pallas_ric2": "ric", "pallas_ric_aug": "ric_aug",
    "pallas_hybrid": "ric_aug",
}


def resolve_solver(mpc_cfg: MPCConf, dtype) -> str:
    """The solver `MPCConf.solver` names; "auto" becomes "fused_ric_aug"
    where that kernel runs and was measured faster than plain XLA (a GPU,
    float32, fixed iterations, its one option set; PERF.md) and "ric_aug"
    everywhere else. "ric_aug" stays the reference and float64 path."""
    if mpc_cfg.solver != "auto":
        return mpc_cfg.solver
    fused = (jax.default_backend() == "gpu"
             and jnp.dtype(dtype) == jnp.float32
             and mpc_cfg.adaptive_tol == 0.0
             and mpc_cfg.solver_foot_split
             and mpc_cfg.solver_refine_steps == 1
             and mpc_cfg.solver_kkt_scale == "none")
    return "fused_ric_aug" if fused else "ric_aug"


def _step(fn):
    """`jax.jit` a `BipedControllerCore` method (self static) with every
    matmul/einsum traced at `precision=HIGHEST`.

    float32 products may otherwise run in TF32 on a GPU, which keeps about
    three decimal digits — far too few for the PDIPM's ill-conditioned
    late-iteration KKT solves. The precision is fixed at trace time, so it
    also covers these steps when a caller inlines them into its own jit.
    """

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return jax.jit(traced, static_argnums=0)


class ControllerState(NamedTuple):
    """All per-env controller state; every leaf has a leading (B, ...) axis."""

    gait_phase: jnp.ndarray  # (B,)
    gait_params: gait.GaitParams  # (B, 2) leaves
    dt_mpc: jnp.ndarray  # (B,) per-env MPC sampling time (DRL knob)
    est: estimator.EstimatorData
    des: mpc.DesiredState
    leg_data: legs.LegData
    leg_cmd: legs.LegCommand
    swing_state: swing.SwingState
    mpc_mem: mpc.MpcMemory
    # DRL knobs (`mpc_wrapper.py:48-64`)
    foot_height: jnp.ndarray  # (B,)
    cp1: jnp.ndarray  # (B,)
    cp2: jnp.ndarray  # (B,)
    residual_lin_accel: jnp.ndarray  # (B, 3)
    residual_ang_accel: jnp.ndarray  # (B, 3)
    # Domain-randomization knobs. The reference bakes both constants into
    # its compiled kernel (mu enters the friction-pyramid rows, F_max the
    # saturation rows of G/d — `srbd_constraints.py:31,144-227`), so
    # randomizing them per env is impossible there; here they are data.
    mu: jnp.ndarray  # (B,) friction coefficient
    f_max: jnp.ndarray  # (B,) per-foot vertical-force cap [N]
    lt: jnp.ndarray  # (B,) toe line-contact lever arm [m]
    lh: jnp.ndarray  # (B,) heel line-contact lever arm [m]
    # Latest MPC products kept for the wrapper properties
    x_ref: jnp.ndarray  # (B, T, 12)
    mpc_cost: jnp.ndarray  # (B,)
    contact_phase: jnp.ndarray  # (B, 2)
    swing_phase: jnp.ndarray  # (B, 2)
    # Learned dynamics-residual matrices (the reference's unimplemented
    # `set_srbd_residual`, `mpc_wrapper.py:66-67`). None (default) keeps
    # the residual-free program; set via MPCController.set_srbd_residual.
    # Note switching None <-> arrays changes the pytree structure, so the
    # step functions recompile once on first use (by design: the zero-
    # residual path stays byte-identical to a build without the feature).
    residual_A: jnp.ndarray | None = None  # (B, 12, 12)
    residual_B: jnp.ndarray | None = None  # (B, 12, 12)


class BipedControllerCore:
    """Static configuration + jitted batched step functions.

    The class itself holds no arrays — it is a namespace of pure functions
    closed over static config, safe to share across states/batches.
    """

    def __init__(self, cfg: ControllerConf, mpc_cfg: MPCConf, gait_id: int = 1,
                 dtype=jnp.float32):
        self.cfg = cfg
        self.mpc_cfg = mpc_cfg
        self.gait_id = gait_id
        self.dtype = dtype
        self.robot: RobotSpec = get_robot(mpc_cfg.robot)
        if mpc_cfg.solver in _REMOVED_SOLVERS:
            raise ValueError(
                f"MPCConf.solver {mpc_cfg.solver!r} was removed; use "
                f"{_REMOVED_SOLVERS[mpc_cfg.solver]!r} (or "
                "'fused_ric_aug', the fused native kernel)"
            )
        if mpc_cfg.solver not in ("auto",) + SOLVERS:
            raise ValueError(
                f"unknown MPCConf.solver {mpc_cfg.solver!r}; expected one of "
                f"{('auto',) + SOLVERS}"
            )
        # The solver every step runs ("auto" resolved once, here).
        self.solver = resolve_solver(mpc_cfg, dtype)
        backend = ("ric_aug" if self.solver == "fused_ric_aug"
                   else self.solver)
        self.opts = PdipmOptions(
            iterations=mpc_cfg.newton_iterations,
            iterations_per_launch=mpc_cfg.adaptive_chunk,
            beta=mpc_cfg.solver_beta,
            delta=mpc_cfg.solver_delta,
            backend=backend,
            refine_steps=mpc_cfg.solver_refine_steps,
            kkt_scale=mpc_cfg.solver_kkt_scale,
            foot_split=mpc_cfg.solver_foot_split
            and backend in ("ric", "ric_aug"),
        )
        self.num_dof = self.robot.num_dof

    # ------------------------------------------------------------------
    # State construction / reset.
    # ------------------------------------------------------------------

    def init_state(self, batch_size: int) -> ControllerState:
        b = batch_size
        dt = self.dtype
        if self.gait_id == 1:
            gp = gait.standing_gait()
        elif self.gait_id == 2:
            gp = gait.walking_gait(self.cfg.dsp_durations, self.cfg.ssp_durations)
        else:
            raise ValueError(f"Invalid gait_id: {self.gait_id} (1 or 2)")
        tile = lambda x: jnp.tile(x[None], (b,) + (1,) * x.ndim)
        gait_params = gait.GaitParams(
            dsp_steps=tile(gp.dsp_steps), ssp_steps=tile(gp.ssp_steps)
        )
        zeros = lambda *shape: jnp.zeros((b,) + shape, dtype=dt)

        vmap0 = lambda f, *a: jax.vmap(lambda _: f(*a))(jnp.arange(b))
        state = ControllerState(
            gait_phase=zeros(),
            gait_params=gait_params,
            dt_mpc=jnp.full((b,), self.mpc_cfg.dt_mpc, dtype=dt),
            est=vmap0(estimator.init_data, dt),
            des=vmap0(mpc.init_desired_state, dt),
            leg_data=vmap0(legs.init_data, self.num_dof, dt),
            leg_cmd=vmap0(legs.init_command, self.num_dof, dt),
            swing_state=vmap0(swing.init_state, dt),
            mpc_mem=vmap0(mpc.init_memory, dt),
            foot_height=jnp.full((b,), self.cfg.swing_height, dtype=dt),
            cp1=jnp.full((b,), 1.0 / 3.0, dtype=dt),
            cp2=jnp.full((b,), 2.0 / 3.0, dtype=dt),
            residual_lin_accel=zeros(3),
            residual_ang_accel=zeros(3),
            mu=jnp.full((b,), float(self.robot.mu), dtype=dt),
            f_max=jnp.full((b,), self.mpc_cfg.f_max, dtype=dt),
            lt=jnp.full((b,), float(self.robot.lt), dtype=dt),
            lh=jnp.full((b,), float(self.robot.lh), dtype=dt),
            x_ref=zeros(self.mpc_cfg.horizon_length, 12),
            mpc_cost=zeros(),
            contact_phase=zeros(2),
            swing_phase=zeros(2),
        )
        # Initialize swing_time_remaining from the gait (`swing_leg_controller.py:104`)
        swing_dur = jax.vmap(gait.swing_duration_sec)(gait_params, state.dt_mpc)
        return state._replace(
            swing_state=state.swing_state._replace(swing_time_remaining=swing_dur)
        )

    @_step
    def reset(self, state: ControllerState, mask: jnp.ndarray) -> ControllerState:
        """Masked episodic reset (`biped_controller.py:82-87`): gait phase to
        0, first-run/first-swing latches re-armed. mask: (B,) bool."""
        return state._replace(
            gait_phase=jnp.where(mask, 0.0, state.gait_phase),
            mpc_mem=jax.vmap(mpc.reset_memory)(state.mpc_mem, mask),
            swing_state=jax.vmap(swing.reset)(state.swing_state, mask),
        )

    # ------------------------------------------------------------------
    # Per-tick entry points.
    # ------------------------------------------------------------------

    @_step
    def set_command(self, state: ControllerState, twist: jnp.ndarray,
                    height: jnp.ndarray) -> ControllerState:
        """twist: (B, 3) = [vx, vy, wz] body frame; height: (B,)
        (`biped_controller.py:92-95`)."""
        # Cast to the controller dtype so callers can feed f32 buffers to
        # an f64 controller (and vice versa) without poisoning the solver
        # state's dtypes (loop carries must typecheck under jit).
        twist = jnp.asarray(twist, dtype=self.dtype)
        height = jnp.asarray(height, dtype=self.dtype)
        des = state.des._replace(
            velocity_b=state.des.velocity_b.at[:, :2].set(twist[:, :2]),
            ang_velocity_b=state.des.ang_velocity_b.at[:, 2].set(twist[:, 2]),
            height=height,
        )
        return state._replace(des=des)

    @_step
    def ingest_state(self, state: ControllerState, obs: jnp.ndarray) -> ControllerState:
        """Split the flat sim state and refresh estimator + leg kinematics.

        obs: (B, 13 + 3 * 2 * dof) = [pos(3), quat(4), v_b(3), w_b(3),
        q(2*dof), qd(2*dof), tau(2*dof)] (`mpc_wrapper.py:20-31`).
        """
        obs = jnp.asarray(obs, dtype=self.dtype)  # see set_command note
        dof2 = 2 * self.num_dof
        position = obs[:, 0:3]
        quat = obs[:, 3:7]
        vel_b = obs[:, 7:10]
        ang_b = obs[:, 10:13]
        q = obs[:, 13: 13 + dof2]
        qd = obs[:, 13 + dof2: 13 + 2 * dof2]
        tau = obs[:, 13 + 2 * dof2: 13 + 3 * dof2]

        contact_phase = jax.vmap(gait.contact_sub_phase)(
            state.gait_phase, state.gait_params
        )
        swing_phase = jax.vmap(gait.swing_sub_phase)(
            state.gait_phase, state.gait_params
        )

        leg_data = jax.vmap(
            lambda *a: legs.update_data(self.robot, *a)
        )(q, qd, tau, contact_phase, swing_phase)

        est = jax.vmap(estimator.estimate)(position, quat, vel_b, ang_b, leg_data.p)
        return state._replace(
            est=est, leg_data=leg_data,
            contact_phase=contact_phase, swing_phase=swing_phase,
        )

    def assemble_mpc(self, state: ControllerState):
        """Vmapped per-env QP assembly phase of `run_mpc`.

        Returns (new_mem, x_ref, qp) with a leading batch axis on every
        leaf. Public so measurement harnesses (accuracy checks) can extract
        the exact production QP batch.
        """
        contact_table = jax.vmap(
            lambda p, g: gait.mpc_contact_table(p, g, self.mpc_cfg.horizon_length)
        )(state.gait_phase, state.gait_params)

        build = functools.partial(
            mpc.build_mpc_qp,
            self.robot,
            horizon=self.mpc_cfg.horizon_length,
            decimation_dt=self.mpc_cfg.decimation * self.mpc_cfg.dt,
            euler_rate_mode=self.mpc_cfg.euler_rate_mode,
            q_weights=jnp.asarray(self.mpc_cfg.Q, dtype=self.dtype),
            r_weights=jnp.asarray(self.mpc_cfg.R, dtype=self.dtype),
            contact_frame=self.mpc_cfg.contact_frame,
        )
        return jax.vmap(
            lambda mem, est, des, ct, dtm, rl, ra, mu, fmax, lt, lh,
            ra_mat, rb_mat:
            build(
                mem, est, des, ct, dtm,
                residual_lin_accel=rl, residual_ang_accel=ra,
                mu=mu, f_max=fmax, lt=lt, lh=lh,
                residual_A=ra_mat, residual_B=rb_mat,
            )
        )(
            state.mpc_mem, state.est, state.des, contact_table,
            state.dt_mpc, state.residual_lin_accel, state.residual_ang_accel,
            state.mu, state.f_max, state.lt, state.lh,
            state.residual_A, state.residual_B,
        )

    @_step
    def run_mpc(self, state: ControllerState):
        """MPC solve at the decimated rate (`biped_controller.py:116-147`).

        Three phases: vmapped per-env QP assembly, one batched PDIPM solve
        (pure-JAX vmap or the fused native kernel, per `self.solver`),
        vmapped postprocess. Returns (state, MpcOutput batched); the wrench
        becomes the leg command's feed-forward term.
        """
        new_mem, x_ref, qp = self.assemble_mpc(state)

        adaptive = self.mpc_cfg.adaptive_tol > 0.0
        if self.solver == "fused_ric_aug":
            from biped_pympc_tpu.ops import pdipm_fused

            if adaptive:
                raise ValueError(
                    "MPCConf.adaptive_tol needs a pure-JAX solver; "
                    "'fused_ric_aug' runs a fixed iteration count"
                )
            sol = pdipm_fused.solve(qp, self.opts)
        elif adaptive:
            sol = pdipm.solve_adaptive_batch(
                qp, self.opts, tol=self.mpc_cfg.adaptive_tol
            )
        else:
            sol = jax.vmap(lambda q: pdipm.solve(q, self.opts))(qp)

        out = jax.vmap(
            lambda q, s, rot, xr: mpc.postprocess_solution(
                q, s, rot, xr, self.mpc_cfg.horizon_length,
                contact_frame=self.mpc_cfg.contact_frame,
            )
        )(qp, sol, state.est.rotation_body, x_ref)

        cmd = state.leg_cmd._replace(wrench_ff=out.wrench)
        state = state._replace(
            mpc_mem=new_mem, leg_cmd=cmd, x_ref=out.x_ref, mpc_cost=out.cost
        )
        return state, out

    @_step
    def run_lowlevel(self, state: ControllerState) -> ControllerState:
        """Swing control + leg command + gait phase advance
        (`biped_controller.py:124-169`)."""
        robot = self.robot
        contact_phase = jax.vmap(gait.contact_sub_phase)(
            state.gait_phase, state.gait_params
        )
        swing_phase = jax.vmap(gait.swing_sub_phase)(
            state.gait_phase, state.gait_params
        )
        swing_dur = jax.vmap(gait.swing_duration_sec)(state.gait_params, state.dt_mpc)

        sw = jax.vmap(
            lambda st, cp, sd: swing.update_swing_time(st, cp, sd, self.mpc_cfg.dt)
        )(state.swing_state, contact_phase, swing_dur)

        hip_positions = jnp.stack(
            [robot.hip_horizontal_location(0, self.dtype),
             robot.hip_horizontal_location(1, self.dtype)]
        )
        sw = jax.vmap(
            lambda st, rp, rb, vw, vb: swing.compute_foot_placement(
                st, rp, rb, vw, vb, hip_positions
            )
        )(sw, state.est.root_position, state.est.rotation_body,
          state.est.root_velocity_w, state.des.velocity_b)

        if self.cfg.swing_reference_frame == "world":
            sw, p_des, v_des = jax.vmap(
                lambda *a: swing.compute_foot_desired_position_world(
                    *a, curve=self.cfg.swing_curve
                )
            )(
                sw, swing_phase, contact_phase, swing_dur,
                state.est.foot_position_w, state.est.root_position,
                state.est.root_velocity_w, state.est.rotation_body,
                state.foot_height, state.cp1, state.cp2,
            )
        else:
            sw, p_des, v_des = jax.vmap(
                lambda *a: swing.compute_foot_desired_position(
                    *a, curve=self.cfg.swing_curve
                )
            )(
                sw, swing_phase, contact_phase, swing_dur,
                state.leg_data.p, state.foot_height, state.cp1, state.cp2,
            )

        cmd = state.leg_cmd._replace(p_des=p_des, v_des=v_des)
        cmd = jax.vmap(lambda d, c: legs.update_command(robot, d, c))(
            state.leg_data, cmd
        )

        phase = jax.vmap(
            lambda p, g, dtm: gait.advance_phase(p, g, self.mpc_cfg.dt, dtm)
        )(state.gait_phase, state.gait_params, state.dt_mpc)

        return state._replace(
            swing_state=sw, leg_cmd=cmd, gait_phase=phase,
            contact_phase=contact_phase, swing_phase=swing_phase,
        )

    @_step
    def joint_torque(self, state: ControllerState) -> jnp.ndarray:
        """(B, 2 * dof) final PD + feed-forward torque, clamped."""
        return jax.vmap(
            lambda d, c: legs.joint_torque(self.robot, d, c)
        )(state.leg_data, state.leg_cmd)

    @_step
    def control_step(self, state: ControllerState, obs: jnp.ndarray,
                     twist: jnp.ndarray, height: jnp.ndarray):
        """Fused full control tick including the MPC solve: command + state
        ingest + MPC + low-level + torque, one compiled program. This is the
        flagship jitted step the benchmarks and multi-chip dryrun exercise.

        Returns (state, tau (B, 2*dof), MpcOutput).
        """
        state = self.set_command(state, twist, height)
        state = self.ingest_state(state, obs)
        state, out = self.run_mpc(state)
        state = self.run_lowlevel(state)
        tau = self.joint_torque(state)
        return state, tau, out
