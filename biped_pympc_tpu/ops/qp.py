"""Structured SRBD-MPC QP assembly — closed-form, zero codegen.

Re-derivation of the reference's symbolic QP former
(`/root/reference/biped_pympc/casadi/srbd_constraints.py:20-227`), exploiting
that the SRBD dynamics are affine at the linearization point (see
`models/srbd.py`), so every matrix has a small closed-form block structure:

  decision z = [x_1..x_T (12 each), u_0..u_{T-1} (12 each)], nz = 24*T
  cost      0.5 z^T H z + f^T z with H = diag([Q]*T ++ [R]*T)   (DIAGONAL)
            f = [-Q*x_ref_1, ..., -Q*x_ref_T, 0, ..., 0]
  equality  A z = b:  per-stage dynamics defect rows (12*T), then per-stage
            Mx_left = Mx_right = 0 rows (2*T)   (`srbd_constraints.py:120-135`)
              row-block i:  x_{i+1} - Ad x_i - Bd u_i = b_i
              b_0 = Ad x0 + cd,  b_i = cd (i>=1)
  inequality G z <= d: 16 rows per stage acting only on u_i
            (`srbd_constraints.py:186-222`): friction pyramid (4/foot),
            line contact lt/lh (2/foot), 0 <= fz <= F_max*contact (2/foot).

The reference materializes H (240x240), A (140x240), G (160x240) through a
CasADi tape compiled to CUDA over ~3 hours; here assembly is O(stage-blocks)
and jit-compiles in seconds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from biped_pympc_tpu.models.srbd import AffineDynamics, SrbdLin, discrete_dynamics

NX = 12  # states per knot
NU = 12  # inputs per stage: [F_L, F_R, M_L, M_R]
N_INEQ_PER_STAGE = 16
N_MX_PER_STAGE = 2  # Mx_left = Mx_right = 0 (no ankle-roll actuation)

# Constants from `srbd_constraints.py:31,161-162`. The reference bakes all
# three into its compiled kernel for EVERY robot; here they are per-call (and
# per-env) data, with these HECTOR-sized values as the defaults. T1's real
# foot geometry lives in `models/robot.py` (RobotSpec.lt/lh).
F_MAX = 500.0
LT = 0.07  # toe lever arm (line contact), HECTOR default
LH = 0.04  # heel lever arm, HECTOR default

# Column indices of u hit by the per-stage inequality rows.
_MX_COLS = (6, 9)  # u_i[6] = Mx_left, u_i[9] = Mx_right


class StageQP(NamedTuple):
    """All per-env data of the structured QP (single env; vmap for batch).

    The horizon is implied by the array shapes (d is (T, 16)) so the tuple is
    a clean jax pytree with no static leaves.
    """

    q_diag: jnp.ndarray  # (12,) state weights
    r_diag: jnp.ndarray  # (12,) input weights
    f: jnp.ndarray  # (nz,) linear cost
    dyn: AffineDynamics  # Ad (12,12), Bd (12,12), cd (12,)
    b0: jnp.ndarray  # (12,) rhs of first dynamics block = Ad x0 + cd
    g_u: jnp.ndarray  # (16, 12) per-stage inequality block (mu-dependent)
    d: jnp.ndarray  # (T, 16) per-stage inequality rhs (contact-dependent)

    @property
    def horizon(self) -> int:
        return self.d.shape[0]

    @property
    def nz(self) -> int:
        return 2 * NX * self.horizon

    @property
    def n_eq(self) -> int:
        return (NX + N_MX_PER_STAGE) * self.horizon

    @property
    def n_ineq(self) -> int:
        return N_INEQ_PER_STAGE * self.horizon


def stage_ineq_block(mu: jnp.ndarray, lt=LT, lh=LH,
                     dtype=jnp.float32) -> jnp.ndarray:
    """(16, 12) inequality rows on u_i = [f1, f2, m1, m2].

    Row order matches `srbd_constraints.py:194-222`:
      [fp_left x-, x+, y-, y+, line lt, line lh, -fz, fz] then same for right.

    lt / lh: toe / heel lever arms [m] of the line contact (how much pitch
    moment the foot can carry per newton of normal force). The reference
    hardcodes HECTOR's 0.07/0.04 for every robot (`srbd_constraints.py:
    161-162`); here they are data — scalars or per-env traced values.
    """
    mu = jnp.asarray(mu, dtype=dtype)
    lt = jnp.asarray(lt, dtype=dtype)
    lh = jnp.asarray(lh, dtype=dtype)
    g = jnp.zeros((16, 12), dtype=dtype)
    for foot, (fc, mc) in enumerate(((0, 6), (3, 9))):
        r = 8 * foot
        # friction pyramid: +-fx - mu fz <= 0, +-fy - mu fz <= 0
        g = g.at[r + 0, fc + 0].set(-1.0).at[r + 0, fc + 2].add(-mu)
        g = g.at[r + 1, fc + 0].set(1.0).at[r + 1, fc + 2].add(-mu)
        g = g.at[r + 2, fc + 1].set(-1.0).at[r + 2, fc + 2].add(-mu)
        g = g.at[r + 3, fc + 1].set(1.0).at[r + 3, fc + 2].add(-mu)
        # line contact: -lt fz - my <= 0 ; -lh fz + my <= 0
        g = g.at[r + 4, fc + 2].add(-lt).at[r + 4, mc + 1].set(-1.0)
        g = g.at[r + 5, fc + 2].add(-lh).at[r + 5, mc + 1].set(1.0)
        # force saturation: -fz <= 0 ; fz <= F_max * contact
        g = g.at[r + 6, fc + 2].set(-1.0)
        g = g.at[r + 7, fc + 2].set(1.0)
    return g


def build_qp(
    lin: SrbdLin,
    x0: jnp.ndarray,
    x_ref: jnp.ndarray,
    contact_table: jnp.ndarray,
    dt_mpc: jnp.ndarray,
    mu: jnp.ndarray,
    q_diag: jnp.ndarray,
    r_diag: jnp.ndarray,
    horizon: int,
    euler_rate_mode: str = "rt_omega",
    f_max: float = F_MAX,
    lt=LT,
    lh=LH,
) -> StageQP:
    """Assemble the structured QP for one env.

    Args mirror the reference qp_former inputs (`srbd_constraints.py:75-79`):
      x0 (12,), x_ref (T, 12), contact_table (T, 2), dt_mpc scalar, mu scalar,
      q_diag/r_diag (12,) cost weights.

    f_max: per-foot vertical-force cap [N]. The reference hardcodes 500 N
    inside the symbolic QP (`srbd_constraints.py:31` — changing it means a
    multi-hour kernel recompile); here it is plain data. 500 N is sized for
    the 13.9 kg HECTOR (~3.7x mg); the 40 kg T1 (mg = 392 N) needs ~800 N
    for equivalent control authority.

    lt / lh: toe / heel lever arms [m] of the line contact (see
    `stage_ineq_block`). Defaults are the reference's hardcoded HECTOR
    values; pass the robot's real foot geometry (`RobotSpec.lt/lh`).
    """
    dtype = x0.dtype
    dyn = discrete_dynamics(lin, dt_mpc, euler_rate_mode)

    # Linear cost: f = -H @ z_ref with z_ref = [x_ref; 0]  (H diagonal).
    f_x = (-(q_diag[None, :] * x_ref)).reshape(-1)
    f = jnp.concatenate([f_x, jnp.zeros(NU * horizon, dtype=dtype)])

    b0 = dyn.A @ x0 + dyn.c

    g_u = stage_ineq_block(mu, lt, lh, dtype=dtype)
    d = jnp.zeros((horizon, N_INEQ_PER_STAGE), dtype=dtype)
    d = d.at[:, 7].set(f_max * contact_table[:, 0])
    d = d.at[:, 15].set(f_max * contact_table[:, 1])

    return StageQP(q_diag=q_diag, r_diag=r_diag, f=f, dyn=dyn, b0=b0,
                   g_u=g_u, d=d)


# ---------------------------------------------------------------------------
# Structured operators (per-env; callers vmap over batch).
# ---------------------------------------------------------------------------

def h_diag(qp: StageQP) -> jnp.ndarray:
    """(nz,) diagonal of H."""
    T = qp.horizon
    return jnp.concatenate([jnp.tile(qp.q_diag, T), jnp.tile(qp.r_diag, T)])


def split_xu(qp: StageQP, zvec: jnp.ndarray):
    """z (nz,) -> x (T, 12), u (T, 12)."""
    T = qp.horizon
    return zvec[: NX * T].reshape(T, NX), zvec[NX * T:].reshape(T, NU)


def g_matvec(qp: StageQP, zvec: jnp.ndarray) -> jnp.ndarray:
    """G @ z -> (n_ineq,). G acts only on the u blocks."""
    _, u = split_xu(qp, zvec)
    return (u @ qp.g_u.T).reshape(-1)


def gT_matvec(qp: StageQP, lam: jnp.ndarray) -> jnp.ndarray:
    """G^T @ lam -> (nz,)."""
    T = qp.horizon
    lam_s = lam.reshape(T, N_INEQ_PER_STAGE)
    gu = lam_s @ qp.g_u  # (T, 12)
    return jnp.concatenate([jnp.zeros(NX * T, dtype=lam.dtype), gu.reshape(-1)])


def a_matvec(qp: StageQP, zvec: jnp.ndarray) -> jnp.ndarray:
    """A @ z -> (n_eq,) in reference row order: 12*T dynamics rows then
    per-stage [mx_left, mx_right] pairs (`srbd_constraints.py:120-135`)."""
    x, u = split_xu(qp, zvec)
    Ad, Bd, _ = qp.dyn
    # constraint i: x_{i+1} - Ad x_i - Bd u_i; x_0 contribution lives in b.
    prev = jnp.concatenate([jnp.zeros((1, NX), dtype=x.dtype), x[:-1]], axis=0)
    dyn_rows = x - prev @ Ad.T - u @ Bd.T  # (T, 12)
    mx_rows = u[:, list(_MX_COLS)]  # (T, 2)
    return jnp.concatenate([dyn_rows.reshape(-1), mx_rows.reshape(-1)])


def aT_matvec(qp: StageQP, y: jnp.ndarray) -> jnp.ndarray:
    """A^T @ y -> (nz,)."""
    T = qp.horizon
    Ad, Bd, _ = qp.dyn
    y_dyn = y[: NX * T].reshape(T, NX)
    y_mx = y[NX * T:].reshape(T, N_MX_PER_STAGE)
    # x_j slot (j = 1..T, index j-1): +y_{j-1} - Ad^T y_j (y_T nonexistent).
    y_next = jnp.concatenate([y_dyn[1:], jnp.zeros((1, NX), dtype=y.dtype)], axis=0)
    grad_x = y_dyn - y_next @ Ad
    grad_u = -(y_dyn @ Bd)
    grad_u = grad_u.at[:, _MX_COLS[0]].add(y_mx[:, 0])
    grad_u = grad_u.at[:, _MX_COLS[1]].add(y_mx[:, 1])
    return jnp.concatenate([grad_x.reshape(-1), grad_u.reshape(-1)])


def b_vec(qp: StageQP) -> jnp.ndarray:
    """(n_eq,) equality rhs."""
    T = qp.horizon
    cd = qp.dyn.c
    b_dyn = jnp.tile(cd, (T, 1)).at[0].set(qp.b0)
    return jnp.concatenate(
        [b_dyn.reshape(-1), jnp.zeros(N_MX_PER_STAGE * T, dtype=cd.dtype)]
    )


def d_vec(qp: StageQP) -> jnp.ndarray:
    """(n_ineq,) inequality rhs."""
    return qp.d.reshape(-1)


# ---------------------------------------------------------------------------
# Dense materialization (tests / golden cross-checks only).
# ---------------------------------------------------------------------------

def dense_matrices(qp: StageQP):
    """Materialize (H, f, A, b, G, d) densely in reference layout.

    Matches the output convention of the reference qp_former
    (`srbd_constraints.py:75-79`); used by the golden CPU PDIPM and tests,
    never by the batched hot path.
    """
    import numpy as np

    T = qp.horizon
    nz, neq, nin = qp.nz, qp.n_eq, qp.n_ineq
    Ad = np.asarray(qp.dyn.A)
    Bd = np.asarray(qp.dyn.B)

    H = np.diag(np.asarray(h_diag(qp)))
    f = np.asarray(qp.f)

    A = np.zeros((neq, nz))
    for i in range(T):
        r = 12 * i
        A[r: r + 12, 12 * i: 12 * i + 12] = np.eye(12)  # +I at x_{i+1}
        if i >= 1:
            A[r: r + 12, 12 * (i - 1): 12 * i] = -Ad
        A[r: r + 12, 12 * T + 12 * i: 12 * T + 12 * i + 12] = -Bd
    for i in range(T):
        A[12 * T + 2 * i, 12 * T + 12 * i + _MX_COLS[0]] = 1.0
        A[12 * T + 2 * i + 1, 12 * T + 12 * i + _MX_COLS[1]] = 1.0
    b = np.asarray(b_vec(qp))

    G = np.zeros((nin, nz))
    gu = np.asarray(qp.g_u)
    for i in range(T):
        G[16 * i: 16 * i + 16, 12 * T + 12 * i: 12 * T + 12 * i + 12] = gu
    d = np.asarray(d_vec(qp))
    return H, f, A, b, G, d
