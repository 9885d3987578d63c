"""RL-facing `MPCController` facade — the reference's public API in JAX.

Mirrors `/root/reference/biped_pympc/mpc_wrapper.py:4-205` method-for-method
and property-for-property. The class is a thin stateful shell around the
functional `BipedControllerCore`: it owns a `ControllerState` pytree and
forwards every call to a jitted batched pure function, so an RL environment
written against the reference API can switch by replacing torch tensors with
jax arrays (numpy arrays are accepted and converted).

    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=4096, gait_id=2)
    ctrl.set_command(twist, height)
    ctrl.update_state(obs)          # every sim step (1 kHz)
    if step % cfg.decimation == 0:
        ctrl.run_mpc()              # 100 Hz batched QP solve
    ctrl.run_lowlevel()
    tau = ctrl.get_action()
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from biped_pympc_tpu.config import ControllerConf, MPCConf
from biped_pympc_tpu.ops import linalg
from biped_pympc_tpu.control import gait, swing
from biped_pympc_tpu.control.controller import BipedControllerCore, ControllerState


class MPCController:
    """Batched biped MPC controller (`mpc_wrapper.py:4-12`)."""

    def __init__(self, cfg: ControllerConf, mpc_cfg: MPCConf, num_envs: int,
                 gait_id: int = 1, dtype=jnp.float32, device=None):
        self.num_envs = num_envs
        self.core = BipedControllerCore(cfg, mpc_cfg, gait_id=gait_id, dtype=dtype)
        self.state: ControllerState = self.core.init_state(num_envs)
        if device is not None:
            self.state = jax.device_put(self.state, device)
        self._last_mpc = None

    # ------------------------------------------------------------------
    # operations (`mpc_wrapper.py:17-43`)
    # ------------------------------------------------------------------

    def set_command(self, twist, height) -> None:
        self.state = self.core.set_command(
            self.state, jnp.asarray(twist), jnp.asarray(height)
        )

    def update_state(self, state_vec) -> None:
        self.state = self.core.ingest_state(self.state, jnp.asarray(state_vec))

    def run_mpc(self) -> None:
        if self.core.mpc_cfg.print_solve_time:
            import time

            t0 = time.perf_counter()
            self.state, self._last_mpc = jax.block_until_ready(
                self.core.run_mpc(self.state)
            )
            # Parity: `biped_controller.py:116-122` wall-clock print. Note
            # this forces device sync — leave print_solve_time off in
            # production (async dispatch pipelines are faster).
            print(f"MPC solve time took:  {1e3*(time.perf_counter()-t0):.3f} ms")
        else:
            self.state, self._last_mpc = self.core.run_mpc(self.state)

    def run_lowlevel(self) -> None:
        if self.core.mpc_cfg.print_solve_time:
            import time

            t0 = time.perf_counter()
            self.state = jax.block_until_ready(self.core.run_lowlevel(self.state))
            print(f"low level control took:  {1e3*(time.perf_counter()-t0):.3f} ms")
        else:
            self.state = self.core.run_lowlevel(self.state)

    def get_action(self) -> jnp.ndarray:
        return self.core.joint_torque(self.state)

    def reset(self, env_ids) -> None:
        """env_ids: int index array (reference convention) or (B,) bool mask."""
        env_ids = jnp.asarray(env_ids)
        if env_ids.dtype == bool:
            mask = env_ids
        else:
            mask = jnp.zeros(self.num_envs, dtype=bool).at[env_ids].set(True)
        self.state = self.core.reset(self.state, mask)

    # ------------------------------------------------------------------
    # DRL interface (`mpc_wrapper.py:48-67`)
    # ------------------------------------------------------------------

    def update_mpc_sampling_time(self, dt_mpc) -> None:
        self.state = self.state._replace(dt_mpc=jnp.asarray(dt_mpc))

    def set_swing_parameters(self, foot_height, cp1, cp2) -> None:
        self.state = self.state._replace(
            foot_height=jnp.asarray(foot_height),
            cp1=jnp.asarray(cp1),
            cp2=jnp.asarray(cp2),
        )

    def set_srbd_accel(self, residual_lin_accel, residual_ang_accel) -> None:
        self.state = self.state._replace(
            residual_lin_accel=jnp.asarray(residual_lin_accel),
            residual_ang_accel=jnp.asarray(residual_ang_accel),
        )

    def set_srbd_residual(self, A_residual, B_residual) -> None:
        """Per-env learned dynamics residuals on the SRBD linearization.

        The reference declares this hook and raises NotImplementedError
        (`mpc_wrapper.py:66-67`); here it is real: A_residual / B_residual
        are (B, 12, 12) matrices added to the continuous-time A / B blocks
        before RK4 discretization (`models/srbd.py`), giving an RL policy
        the full state/input-dependent model-correction interface on top
        of the constant acceleration residuals (`set_srbd_accel`).

        Pass None for both to clear back to the exact residual-free
        program. Passing exactly ONE of the two as None zero-fills the
        other (a residual on only the A or B block is a legitimate model
        correction; the zeros are allocated in the controller dtype) —
        pass both as arrays if you want explicit control. First use (and
        clearing) changes the state pytree structure, so the jitted step
        recompiles once.
        """
        if (A_residual is None) != (B_residual is None):
            zeros = jnp.zeros(
                (self.num_envs, 12, 12), self.state.gait_phase.dtype)
            A_residual = zeros if A_residual is None else A_residual
            B_residual = zeros if B_residual is None else B_residual
        if A_residual is not None:
            A_residual = jnp.asarray(A_residual)
            B_residual = jnp.asarray(B_residual)
            want = (self.num_envs, 12, 12)
            if A_residual.shape != want or B_residual.shape != want:
                raise ValueError(
                    f"set_srbd_residual expects shapes {want}, got "
                    f"{A_residual.shape} and {B_residual.shape}"
                )
        self.state = self.state._replace(
            residual_A=A_residual, residual_B=B_residual)

    def set_contact_parameters(self, mu=None, f_max=None, lt=None,
                               lh=None) -> None:
        """Per-env contact parameters: friction coefficient, per-foot
        vertical-force cap [N], and toe/heel line-contact lever arms [m].

        Domain-randomization knobs beyond the reference: all four are baked
        into its compiled kernel (`srbd_constraints.py:31,144-227,161-162`),
        here they are per-env data. Pass (B,) arrays (or scalars to
        broadcast); None leaves a parameter unchanged. lt/lh default to the
        robot's real foot geometry (`RobotSpec.lt/lh`).
        """
        state = self.state
        for name, val in (("mu", mu), ("f_max", f_max), ("lt", lt),
                          ("lh", lh)):
            if val is not None:
                cur = getattr(state, name)
                state = state._replace(**{name: jnp.broadcast_to(
                    jnp.asarray(val, cur.dtype), cur.shape)})
        self.state = state

    # ------------------------------------------------------------------
    # properties (`mpc_wrapper.py:72-205`)
    # ------------------------------------------------------------------

    @property
    def ground_reaction_wrench(self) -> jnp.ndarray:
        """(B, 2, 6) body-frame feed-forward wrench (`mpc_wrapper.py:72-77`)."""
        return self.state.leg_cmd.wrench_ff

    @property
    def grf_world(self) -> jnp.ndarray:
        """(B, 12) raw world-frame QP input u0 = [F_L, F_R, M_L, M_R] from the
        most recent `run_mpc` (the quantity the reference reads at
        `mpc_controller_cusadi.py:186` before its body-frame transform).
        Zeros until the first `run_mpc` call."""
        if self._last_mpc is None:
            return jnp.zeros(
                (self.num_envs, 12), self.state.gait_phase.dtype
            )
        return self._last_mpc.grf_world

    @property
    def solver_residuals(self) -> jnp.ndarray:
        """(B, 4) final PDIPM residual norms [||rx||, ||rs||, ||re||, mu]
        from the most recent `run_mpc`; +inf until the first call."""
        if self._last_mpc is None:
            return jnp.full(
                (self.num_envs, 4), jnp.inf, self.state.gait_phase.dtype
            )
        return self._last_mpc.residuals

    @property
    def centroidal_accel(self) -> jnp.ndarray:
        """(B, 6) [linear; angular] acceleration from the commanded wrench
        (`mpc_wrapper.py:79-88`)."""
        w = self.state.leg_cmd.wrench_ff  # (B, 2, 6)
        robot = self.core.robot
        lin = jnp.sum(w[:, :, :3], axis=1) / robot.mass
        rot = self.state.est.rotation_body
        with jax.default_matmul_precision("highest"):  # no TF32 (see _step)
            i_world = jnp.einsum(
                "bij,jk,blk->bil", rot, jnp.asarray(robot.i_body, w.dtype), rot
            )
            ang = jnp.einsum(
                "bij,bj->bi", linalg.inverse_3x3(i_world),
                jnp.sum(w[:, :, 3:], axis=1)
            )
        return jnp.concatenate([lin, ang], axis=1)

    @property
    def contact_state(self) -> jnp.ndarray:
        """(B, 2) 1 while in stance (`mpc_wrapper.py:90-94`)."""
        return (self.state.contact_phase != -1).astype(self.state.gait_phase.dtype)

    @property
    def contact_phase(self) -> jnp.ndarray:
        """(B, 2) stance sub-phase, 0 while swinging (`mpc_wrapper.py:96-100`)."""
        cp = self.state.contact_phase
        return jnp.where(cp == -1, 0.0, cp)

    @property
    def swing_state(self) -> jnp.ndarray:
        return (self.state.swing_phase != -1).astype(self.state.gait_phase.dtype)

    @property
    def swing_phase(self) -> jnp.ndarray:
        sp = self.state.swing_phase
        return jnp.where(sp == -1, 0.0, sp)

    @property
    def foot_placement(self) -> jnp.ndarray:
        """(B, 2, 3) planned world-frame footholds (`mpc_wrapper.py:114-119`)."""
        return self.state.swing_state.foot_placement_w

    @property
    def foot_placement_b(self) -> jnp.ndarray:
        return self.state.swing_state.foot_placement_b

    @property
    def ref_foot_pos_b(self) -> jnp.ndarray:
        return self.state.leg_cmd.p_des

    @property
    def ref_foot_vel_b(self) -> jnp.ndarray:
        return self.state.leg_cmd.v_des

    @property
    def foot_pos_b(self) -> jnp.ndarray:
        return self.state.leg_data.p

    @property
    def foot_vel_b(self) -> jnp.ndarray:
        return self.state.leg_data.v

    @property
    def mpc_cost(self) -> jnp.ndarray:
        return self.state.mpc_cost

    @property
    def position_trajectory(self) -> jnp.ndarray:
        """(B, T, 3) rpy-free position part of x_ref (`mpc_wrapper.py:155-157`
        returns x_ref[:, :, :3]; note the reference slices the *euler* block —
        we keep its literal behavior)."""
        return self.state.x_ref[:, :, :3]

    @property
    def velocity_trajectory(self) -> jnp.ndarray:
        """(B, T, 3) linear-velocity rows of x_ref. (The reference property
        reads a nonexistent `x_ref_dot` attribute and raises,
        `mpc_wrapper.py:159-161`; we return the meaningful quantity.)"""
        return self.state.x_ref[:, :, 9:12]

    @property
    def swing_foot_trajectory(self) -> jnp.ndarray:
        """(B, 10, 3) body-frame swing trajectory of the currently swinging
        foot, sampled at 10 phases (`mpc_wrapper.py:163-205`)."""
        st = self.state
        num_samples = 10
        phases = jnp.linspace(0.0, 1.0, num_samples, dtype=st.gait_phase.dtype)
        swing_dur = jax.vmap(gait.swing_duration_sec)(st.gait_params, st.dt_mpc)

        def env_traj(sw_state: swing.SwingState, dur, height, cp1, cp2, contact_bool):
            def leg_curve(i):
                def at_phase(ph):
                    p, _ = swing.cubic_bezier(
                        ph, dur[i], sw_state.p0[i],
                        sw_state.foot_placement_b[i], height, cp1, cp2,
                    )
                    return p
                return jax.vmap(at_phase)(phases)  # (10, 3)

            left = leg_curve(0)
            right = leg_curve(1)
            return (
                left * (1.0 - contact_bool[0]) + right * (1.0 - contact_bool[1])
            )

        return jax.vmap(env_traj)(
            st.swing_state, swing_dur, st.foot_height, st.cp1, st.cp2,
            st.leg_data.contact_bool,
        )

    # ------------------------------------------------------------------
    # Checkpoint / resume (no reference equivalent — the reference's only
    # persistent artifacts are offline .casadi/.so caches; here the whole
    # controller state is an explicit pytree, so episodic state survives
    # process restarts trivially).
    # ------------------------------------------------------------------

    def save_state(self, path: str) -> None:
        """Serialize the full per-env controller state to an .npz file."""
        leaves, treedef = jax.tree.flatten(self.state)
        np.savez(
            path,
            __treedef__=np.frombuffer(
                repr(treedef).encode(), dtype=np.uint8
            ),
            **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
        )

    def load_state(self, path: str) -> None:
        """Restore controller state saved by `save_state` (same config).

        The saved pytree STRUCTURE must match the current state's: the
        optional residual_A/B leaves (`set_srbd_residual`) change the
        ControllerState structure, so a checkpoint saved with residuals
        set cannot be loaded into a residual-free controller (or vice
        versa) — call `set_srbd_residual` first to match, then load.
        """
        data = np.load(path)
        leaves, treedef = jax.tree.flatten(self.state)
        saved_treedef = bytes(data["__treedef__"]).decode()
        if saved_treedef != repr(treedef):
            raise ValueError(
                "checkpoint pytree structure does not match the current "
                "controller state (most commonly: residual_A/B leaves from "
                "set_srbd_residual present on one side only — call "
                "set_srbd_residual to match the saved structure before "
                f"load_state).\n  saved:   {saved_treedef[:200]}...\n"
                f"  current: {repr(treedef)[:200]}..."
            )
        new_leaves = []
        for i, old in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != old.shape:
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != {old.shape} "
                    "(batch size / config mismatch)"
                )
            new_leaves.append(jnp.asarray(arr, old.dtype))
        self.state = jax.tree.unflatten(treedef, new_leaves)

    # convenience
    def to_numpy(self, x) -> np.ndarray:
        return np.asarray(x)
