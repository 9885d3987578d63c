"""Batched fixed-iteration Mehrotra PDIPM for the SRBD-MPC QP — pure JAX.

JAX re-expression of the reference's CasADi-unrolled solver
(`/root/reference/biped_pympc/casadi/sparse_pdipm_solver.py:357-534`) and its
generated CUDA kernel. Same update rule, different linear algebra:

The reference factors the full (nz + 2*ni + ne)-dim augmented KKT with pivoted
LDL per Newton step. Here the two diagonal rows (slacks s, ineq duals z) are
eliminated *analytically* — they are elementwise — leaving the symmetric
quasi-definite reduced system

    [[H + beta I + G^T W^-1 G,  A^T],        W = Sigma^-1 + delta I,
     [A,                     -delta I]]      Sigma = S^-1 Z + delta I

of dim nz + ne (380 for horizon 10 vs the reference's 700). This block
elimination is algebraically exact for the same regularized system, so iterates
match the reference to roundoff (validated against `ops/reference_pdipm.py`).

Two interchangeable factorizations:
  * "dense":   batched LU of the reduced matrix (jax.scipy lu_factor/lu_solve).
  * "tridiag": block-tridiagonal LDL-style Thomas sweep over the stage
               structure — the per-stage variable ordering
               [u_i, nu_i, y_i, x_{i+1}] makes the reduced KKT block-tridiag
               with a *constant* off-diagonal coupling (-Ad between x_i and the
               stage-i dynamics rows), i.e. a Riccati-like O(T) factorization
               instead of O((T n)^3).

Everything is written per-env and `jax.vmap`-ed over the environment batch; the
batch axis shards over the device mesh (see `parallel/mesh.py`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from biped_pympc_tpu.ops import qp as qps
from biped_pympc_tpu.ops.linalg import gauss_jordan_inverse
from biped_pympc_tpu.ops.qp import NU, NX, N_INEQ_PER_STAGE, N_MX_PER_STAGE, StageQP

# Stage block layout for the tridiag backend: [u(12), nu(2), y(12), x_next(12)].
_SB_U = 0
_SB_NU = NU
_SB_Y = NU + N_MX_PER_STAGE
_SB_X = NU + N_MX_PER_STAGE + NX
SB = NU + N_MX_PER_STAGE + 2 * NX  # 38

# Augmented layout: [u(12), z(16), nu(2), y(12), x_next(12)] — keeps the
# inequality duals in the stage block instead of condensing G^T W^-1 G,
# avoiding the normal-equations conditioning squaring (critical in f32).
_SA_U = 0
_SA_Z = NU
_SA_NU = NU + N_INEQ_PER_STAGE
_SA_Y = _SA_NU + N_MX_PER_STAGE
_SA_X = _SA_Y + NX
SA = NU + N_INEQ_PER_STAGE + N_MX_PER_STAGE + 2 * NX  # 54


class PdipmOptions(NamedTuple):
    """Solver constants, defaults per the reference (`sparse_pdipm_solver.py`)."""

    iterations: int = 20  # 4 outer x 5 fused (`mpc_controller_cusadi.py:28,144`)
    iterations_per_launch: int = 5  # adaptive mode only: Newton steps per
    # kernel launch inside `solve_adaptive`'s while_loop (the reference's
    # fused-kernel granularity). Ignored by the fixed-iteration `solve`.
    beta: float = 1e-8  # primal regularization (`:419`)
    delta: float = 1e-8  # dual regularization (`:416`)
    frac_to_boundary: float = 0.99  # (`:461`)
    alpha_min: float = 1e-12  # (`:466-467`)
    sz_floor: float = 1e-8  # slack/dual clamp (`:511-515`)
    backend: str = "tridiag"  # "tridiag" | "tridiag_aug" | "dense" | "ric"
    # | "ric_aug" | "ric_aug_core"
    refine_steps: int = 0  # iterative-refinement passes on the reduced solve
    # (0 suffices in f64; use 1-2 in f32 to recover accuracy lost to the
    # ill-conditioned late-iteration KKT)
    refine_residual: str = "f32"  # "f32" | "df": precision of the
    # iterative-refinement RESIDUAL r - K d. AUG backends only
    # ("tridiag_aug"/"ric_aug"); the condensed backends reject "df" (their
    # refinement residual runs through the G^T W^-1 G condensation, where
    # W^-1 products would need a compensated chain). "df" computes every
    # residual component as one compensated (double-float) linear
    # combination (`ops/df.py`) — the standard mixed-precision refinement
    # practice: the f32 residual is a catastrophic cancellation whose
    # surviving digits are the f32 matvec's own rounding error, so f32
    # refinement can stall above the achievable accuracy. Costs ~25
    # elementwise flops per accumulated term in the operator apply (the
    # apply is a small fraction of the factorization).
    sigma_cap: float = 0.0  # if > 0, cap the complementarity scaling z/s at
    # this value. Bounds the reduced-KKT condition number in f32; active
    # constraints are then enforced to ~1/sigma_cap relative feasibility
    # (proximal smoothing). 0 disables (exact reference rule). Unusable on
    # the MPC workload — the force caps/friction rows are strongly active
    # and capping their scaling costs tens of newtons of GRF error. Kept
    # for diagnostics only.
    inv_impl: str = "gj"  # "gj" (batched Gauss-Jordan, elementwise steps)
    # or "lapack" (jnp.linalg.inv; kept as a cross-check)
    corrector_form: str = "delta"  # All three are algebraically identical
    # (refinement is a linear map), differing in solve count and f32
    # rounding:
    # * "delta": the reference rule — refined affine solve + refined
    #   corrector-increment solve (zero KKT rhs), added. 4 solves + 2
    #   operator applies per iteration at refine_steps=1.
    # * "combined": one refined solve of the summed Mehrotra rhs; the
    #   affine solve runs unrefined (feeds only sigma and ds*dz). 3 solves
    #   + 1 apply — but REJECTED as default: the summed rhs mixes the
    #   KKT-residual and complementarity scales in one f32 solve and the
    #   stress tail degrades ~10x.
    # * "sum_refine": unrefined affine + unrefined corrector (both solves
    #   stay scale-separated), then refine the SUMMED direction against
    #   the full 4-row KKT residual — the refinement rhs is a small
    #   correction, exactly where f32 is safe. Also 3 solves + 1 apply.
    # * "aff_ref": refined affine + UNREFINED corrector. 3 solves + 1
    #   apply. Hypothesis from the sum_refine isolation: the f32 failure
    #   mode of the cheap forms would be the unrefined AFFINE predictor
    #   poisoning sigma and the ds*dz corrector products, with the
    #   corrector solve's own error entering only linearly. REJECTED: a
    #   stress-set tail far above "delta"'s; kept for diagnostics.
    foot_split: bool = False  # "ric"/"ric_aug": exploit the EXACT foot
    # decoupling of the stage [u, nu] / [u, z, nu] blocks. No cost term,
    # G row, or Mx selector couples foot L's inputs {F_L, M_L} to foot R's
    # — only the dynamics (Bd, handled by the y-chain) do — so K_t is
    # block-diagonal: per foot a dense [F(3), M_y(1)] (condensed, SPD) or
    # [F(3), M_y(1), z_f(8)] (augmented) block, plus W-independent 2x2
    # [M_x, nu] pairs and bare M_z scalars (verified exactly, zero
    # off-block entries). Elimination work drops ~21x ("ric": two 4-wide
    # vs one 14-wide GJ) / ~7.8x ("ric_aug": two 12-wide vs one 30-wide);
    # per-foot partial pivoting retains the augmented form's f32
    # robustness (pivoting across exactly-decoupled blocks is vacuous).
    kkt_scale: str = "none"  # "none" | "jacobi". Jacobi (symmetric diagonal)
    # equilibration of the per-stage KKT block INVERSES: the block is
    # congruence-scaled to ~unit diagonal (K_hat = D K D, D = rsqrt(|diag|))
    # before elimination and the inverse unscaled after (K^-1 = D K_hat^-1 D).
    # Pure preconditioning of the factorization — iterates are algebraically
    # identical to the reference rule at every step; only f32 rounding
    # changes. This is the standard IPM treatment for the scale-spread
    # pathologies behind every recorded f32 accuracy failure (1e8-scale
    # condensed W blocks, R ~ 1e-5 u pivots vs O(1) couplings). Applies to
    # the "ric"/"ric_aug" stage inverses; "ric_aug_core" embeds its own
    # static u-scaling and ignores this knob.


class PdipmState(NamedTuple):
    x: jnp.ndarray  # (nz,)
    s: jnp.ndarray  # (ni,)
    z: jnp.ndarray  # (ni,)
    y: jnp.ndarray  # (ne,)


class PdipmResult(NamedTuple):
    x: jnp.ndarray
    s: jnp.ndarray
    z: jnp.ndarray
    y: jnp.ndarray
    residuals: jnp.ndarray  # [||rx||, ||rs||, ||re||, mu] last iteration


def init_state(qp: StageQP) -> PdipmState:
    """x=0, s=max(d - Gx, 1)=max(d, 1), z=1, y=1 (`mpc_controller_cusadi.py:138-141`)."""
    d = qps.d_vec(qp)
    # All fields derive from the QP data (not fresh constants) so they carry
    # shard_map varying axes and loop carries typecheck under explicit SPMD.
    return PdipmState(
        x=0.0 * qp.f,
        s=jnp.maximum(d, 1.0),
        z=0.0 * d + 1.0,
        y=0.0 * qps.b_vec(qp) + 1.0,
    )


def _frac_to_boundary(v, dv, opts: PdipmOptions):
    cand = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), 1.0)
    alpha = jnp.minimum(1.0, opts.frac_to_boundary * jnp.min(cand))
    return jnp.maximum(alpha, opts.alpha_min)


# ---------------------------------------------------------------------------
# Reduced-system factorizations.
# ---------------------------------------------------------------------------

def _stage_hessians(qp: StageQP, w_inv: jnp.ndarray, opts: PdipmOptions):
    """Per-stage u-block Hessian R~ = diag(R) + beta + G_u^T diag(w_inv) G_u.

    w_inv: (T, 16). Returns (T, 12, 12).
    """
    gu = qp.g_u
    gtwg = jnp.einsum("ki,tk,kj->tij", gu, w_inv, gu)
    return gtwg + jnp.diag(qp.r_diag + opts.beta)[None]


def _factor_dense(qp: StageQP, w_inv: jnp.ndarray, opts: PdipmOptions):
    """Dense LU of the reduced KKT. Variable order [x (12T), u (12T), y (ne)]."""
    T = qp.horizon
    nz, ne = qp.nz, qp.n_eq
    dim = nz + ne
    dtype = qp.f.dtype

    m = jnp.zeros((dim, dim), dtype=dtype)
    hd = qps.h_diag(qp) + opts.beta
    m = m + jnp.diag(jnp.concatenate([hd, jnp.full((ne,), -opts.delta, dtype=dtype)]))

    # u-block coupling G^T W^-1 G (per stage, block diagonal).
    ru = _stage_hessians(qp, w_inv, opts) - jnp.diag(qp.r_diag + opts.beta)[None]
    ublock = jax.scipy.linalg.block_diag(*[ru[i] for i in range(T)])
    m = m.at[NX * T: nz, NX * T: nz].add(ublock)

    # A blocks (constant within a solve).
    a_dense = _dense_a(qp)
    m = m.at[nz:, :nz].set(a_dense)
    m = m.at[:nz, nz:].set(a_dense.T)

    lu, piv = jax.scipy.linalg.lu_factor(m)
    return (lu, piv)


def _solve_dense(qp: StageQP, factors, r1_hat, r4):
    lu, piv = factors
    sol = jax.scipy.linalg.lu_solve((lu, piv), jnp.concatenate([r1_hat, r4]))
    return sol[: qp.nz], sol[qp.nz:]


def _dense_a(qp: StageQP) -> jnp.ndarray:
    """Dense A (ne, nz) in reference row order; built from the stage blocks."""
    T = qp.horizon
    Ad, Bd, _ = qp.dyn
    dtype = Ad.dtype
    a = jnp.zeros((qp.n_eq, qp.nz), dtype=dtype)
    eye = jnp.eye(NX, dtype=dtype)
    for i in range(T):
        r = NX * i
        a = a.at[r: r + NX, NX * i: NX * (i + 1)].set(eye)
        if i >= 1:
            a = a.at[r: r + NX, NX * (i - 1): NX * i].set(-Ad)
        a = a.at[r: r + NX, NX * T + NU * i: NX * T + NU * (i + 1)].set(-Bd)
    for i in range(T):
        a = a.at[NX * T + 2 * i, NX * T + NU * i + 6].set(1.0)
        a = a.at[NX * T + 2 * i + 1, NX * T + NU * i + 9].set(1.0)
    return a


# --- Block-tridiagonal (Riccati-like) backend ------------------------------

def _stage_diag_blocks(qp: StageQP, w_inv: jnp.ndarray, opts: PdipmOptions):
    """(T, 38, 38) stage-diagonal blocks D_i of the reduced KKT.

    Stage variables s_i = [u_i, nu_i, y_i, x_{i+1}]:
      D[u,u]   = diag(R)+beta + G_u^T W_i^-1 G_u
      D[nu,u]  = E (rows e_6, e_9 — the Mx selector, `srbd_constraints.py:129-135`)
      D[nu,nu] = -delta I
      D[y,u]   = -Bd,  D[y,y] = -delta I,  D[y,x] = I
      D[x,x]   = diag(Q)+beta
    Off-diagonal coupling (constant across stages): C has -Ad at (y-rows of
    stage i) x (x-cols of stage i-1).
    """
    T = qp.horizon
    dtype = qp.f.dtype
    Ad, Bd, _ = qp.dyn

    ru = _stage_hessians(qp, w_inv, opts)  # (T, 12, 12)

    d = jnp.zeros((T, SB, SB), dtype=dtype)
    d = d.at[:, _SB_U:_SB_NU, _SB_U:_SB_NU].set(ru)
    e = jnp.zeros((N_MX_PER_STAGE, NU), dtype=dtype).at[0, 6].set(1.0).at[1, 9].set(1.0)
    d = d.at[:, _SB_NU:_SB_Y, _SB_U:_SB_NU].set(e[None])
    d = d.at[:, _SB_U:_SB_NU, _SB_NU:_SB_Y].set(e.T[None])
    d = d.at[:, _SB_NU:_SB_Y, _SB_NU:_SB_Y].set(
        -opts.delta * jnp.eye(N_MX_PER_STAGE, dtype=dtype)[None]
    )
    d = d.at[:, _SB_Y:_SB_X, _SB_U:_SB_NU].set(-Bd[None])
    d = d.at[:, _SB_U:_SB_NU, _SB_Y:_SB_X].set(-Bd.T[None])
    d = d.at[:, _SB_Y:_SB_X, _SB_Y:_SB_X].set(
        -opts.delta * jnp.eye(NX, dtype=dtype)[None]
    )
    eye12 = jnp.eye(NX, dtype=dtype)
    d = d.at[:, _SB_Y:_SB_X, _SB_X:].set(eye12[None])
    d = d.at[:, _SB_X:, _SB_Y:_SB_X].set(eye12[None])
    d = d.at[:, _SB_X:, _SB_X:].set(jnp.diag(qp.q_diag + opts.beta)[None])
    return d


def _factor_tridiag(qp: StageQP, w_inv: jnp.ndarray, opts: PdipmOptions):
    """Forward block-Thomas sweep: S_0 = D_0, S_i = D_i - C S_{i-1}^-1 C^T.

    Because C = P_y (-Ad) P_x^T, the correction only touches the (y, y)
    sub-block: S_i[y, y] -= Ad (S_{i-1}^-1)[x, x] Ad^T. We store S_i^-1
    (T, 38, 38); 38x38 inverses are exact block elimination of the same
    regularized system the reference LDL-factors, so no pivoting is needed
    (symmetric quasi-definite structure).
    """
    Ad = qp.dyn.A
    d = _stage_diag_blocks(qp, w_inv, opts)

    inv = gauss_jordan_inverse if opts.inv_impl == "gj" else jnp.linalg.inv

    def step(m_prev_xx, d_i):
        s_i = d_i.at[_SB_Y:_SB_X, _SB_Y:_SB_X].add(-Ad @ m_prev_xx @ Ad.T)
        s_inv = inv(s_i)
        return s_inv[_SB_X:, _SB_X:], s_inv

    # First stage has no predecessor: seed the scan with a zero xx-inverse.
    # (Derived from the data rather than a constant so the carry carries the
    # same shard_map varying axes as the loop output.)
    zero = 0.0 * d[0, _SB_X:, _SB_X:]
    _, s_invs = jax.lax.scan(step, zero, d)
    return s_invs  # (T, 38, 38)


def _canonical_to_stage(qp: StageQP, r1: jnp.ndarray, r4: jnp.ndarray):
    """Pack rhs [x; u] (nz) and y (ne) into (T, 38) stage vectors."""
    T = qp.horizon
    rx = r1[: NX * T].reshape(T, NX)
    ru = r1[NX * T:].reshape(T, NU)
    ry = r4[: NX * T].reshape(T, NX)
    rnu = r4[NX * T:].reshape(T, N_MX_PER_STAGE)
    return jnp.concatenate([ru, rnu, ry, rx], axis=1)


def _stage_to_canonical(qp: StageQP, w: jnp.ndarray):
    """Unpack (T, 38) stage solution to (dxz (nz,), dy (ne,))."""
    T = qp.horizon
    du = w[:, _SB_U:_SB_NU]
    dnu = w[:, _SB_NU:_SB_Y]
    dy = w[:, _SB_Y:_SB_X]
    dx = w[:, _SB_X:]
    dxz = jnp.concatenate([dx.reshape(-1), du.reshape(-1)])
    dyv = jnp.concatenate([dy.reshape(-1), dnu.reshape(-1)])
    return dxz, dyv


def _solve_tridiag(qp: StageQP, s_invs, r1_hat, r4):
    """Two-sweep block-Thomas solve with the stored stage inverses."""
    Ad = qp.dyn.A
    r = _canonical_to_stage(qp, r1_hat, r4)  # (T, 38)

    # Forward: g_i = r_i - C S_{i-1}^-1 g_{i-1}; only y-rows are touched:
    # g_i[y] += Ad (S_{i-1}^-1 g_{i-1})[x].
    def fwd(carry, inp):
        s_inv_prev, g_prev = carry
        r_i, s_inv_i = inp
        sol_prev = s_inv_prev @ g_prev
        g_i = r_i.at[_SB_Y:_SB_X].add(Ad @ sol_prev[_SB_X:])
        return (s_inv_i, g_i), g_i

    zero_inv = 0.0 * s_invs[0]
    zero_g = 0.0 * r[0]
    (_, _), g = jax.lax.scan(fwd, (zero_inv, zero_g), (r, s_invs))

    # Backward: w_T = S_T^-1 g_T; w_i = S_i^-1 (g_i + C^T-correction):
    # (g_i)[x] += Ad^T w_{i+1}[y] with sign: C^T w has -Ad^T at x-rows, and we
    # subtract it, so add +Ad^T w_{i+1}[y].
    def bwd(w_next, inp):
        g_i, s_inv_i = inp
        g_mod = g_i.at[_SB_X:].add(Ad.T @ w_next[_SB_Y:_SB_X])
        w_i = s_inv_i @ g_mod
        return w_i, w_i

    _, w_rev = jax.lax.scan(bwd, 0.0 * g[0], (g, s_invs), reverse=True)
    return _stage_to_canonical(qp, w_rev)


# --- Augmented block-tridiagonal backend (f32-robust) ----------------------

def _stage_diag_blocks_aug(qp: StageQP, w_diag: jnp.ndarray, opts: PdipmOptions):
    """(T, 54, 54) stage blocks keeping the inequality duals z in the block.

    Avoids forming G^T W^-1 G: the normal-equations condensation *squares*
    the complementarity conditioning (w = z/s up to 1e8 gets mixed into a
    dense 12x12 block), which is what breaks plain f32. In augmented form
    every extreme scale sits on its own diagonal entry (-W_i), where LU with
    partial pivoting eliminates it cleanly — f32 stays accurate.

    w_diag: (T, 16) = Sigma^-1 + delta per inequality row.
    """
    T = qp.horizon
    dtype = qp.f.dtype
    Ad, Bd, _ = qp.dyn

    d = jnp.zeros((T, SA, SA), dtype=dtype)
    d = d.at[:, _SA_U:_SA_Z, _SA_U:_SA_Z].set(jnp.diag(qp.r_diag + opts.beta)[None])
    d = d.at[:, _SA_U:_SA_Z, _SA_Z:_SA_NU].set(qp.g_u.T[None])
    d = d.at[:, _SA_Z:_SA_NU, _SA_U:_SA_Z].set(qp.g_u[None])
    zi = jnp.arange(N_INEQ_PER_STAGE)
    d = d.at[:, _SA_Z + zi, _SA_Z + zi].set(-w_diag)
    e = jnp.zeros((N_MX_PER_STAGE, NU), dtype=dtype).at[0, 6].set(1.0).at[1, 9].set(1.0)
    d = d.at[:, _SA_NU:_SA_Y, _SA_U:_SA_Z].set(e[None])
    d = d.at[:, _SA_U:_SA_Z, _SA_NU:_SA_Y].set(e.T[None])
    d = d.at[:, _SA_NU:_SA_Y, _SA_NU:_SA_Y].set(
        -opts.delta * jnp.eye(N_MX_PER_STAGE, dtype=dtype)[None]
    )
    d = d.at[:, _SA_Y:_SA_X, _SA_U:_SA_Z].set(-Bd[None])
    d = d.at[:, _SA_U:_SA_Z, _SA_Y:_SA_X].set(-Bd.T[None])
    d = d.at[:, _SA_Y:_SA_X, _SA_Y:_SA_X].set(
        -opts.delta * jnp.eye(NX, dtype=dtype)[None]
    )
    eye12 = jnp.eye(NX, dtype=dtype)
    d = d.at[:, _SA_Y:_SA_X, _SA_X:].set(eye12[None])
    d = d.at[:, _SA_X:, _SA_Y:_SA_X].set(eye12[None])
    d = d.at[:, _SA_X:, _SA_X:].set(jnp.diag(qp.q_diag + opts.beta)[None])
    return d


def _factor_tridiag_aug(qp: StageQP, w_diag: jnp.ndarray, opts: PdipmOptions):
    """Same Riccati-like sweep as `_factor_tridiag` on the 54-wide blocks;
    the off-diagonal coupling is still only (-Ad) between y-rows and the
    previous stage's x-cols, so only S_i[y, y] receives a Schur correction."""
    Ad = qp.dyn.A
    d = _stage_diag_blocks_aug(qp, w_diag, opts)

    inv = gauss_jordan_inverse if opts.inv_impl == "gj" else jnp.linalg.inv

    def step(m_prev_xx, d_i):
        s_i = d_i.at[_SA_Y:_SA_X, _SA_Y:_SA_X].add(-Ad @ m_prev_xx @ Ad.T)
        s_inv = inv(s_i)
        return s_inv[_SA_X:, _SA_X:], s_inv

    zero = 0.0 * d[0, _SA_X:, _SA_X:]
    _, s_invs = jax.lax.scan(step, zero, d)
    return s_invs  # (T, 54, 54)


def _pack_stage_aug(qp: StageQP, r1, r_z, r4):
    """rhs -> (T, 54) stage vectors [r_u, r_z, r_nu, r_y, r_x]."""
    T = qp.horizon
    rx = r1[: NX * T].reshape(T, NX)
    ru = r1[NX * T:].reshape(T, NU)
    rz = r_z.reshape(T, N_INEQ_PER_STAGE)
    ry = r4[: NX * T].reshape(T, NX)
    rnu = r4[NX * T:].reshape(T, N_MX_PER_STAGE)
    return jnp.concatenate([ru, rz, rnu, ry, rx], axis=1)


def _solve_tridiag_aug(qp: StageQP, s_invs, r1, r_z, r4):
    """Block-Thomas solve; returns (dx (nz,), dz (ni,), dy (ne,))."""
    Ad = qp.dyn.A
    r = _pack_stage_aug(qp, r1, r_z, r4)

    def fwd(carry, inp):
        s_inv_prev, g_prev = carry
        r_i, s_inv_i = inp
        sol_prev = s_inv_prev @ g_prev
        g_i = r_i.at[_SA_Y:_SA_X].add(Ad @ sol_prev[_SA_X:])
        return (s_inv_i, g_i), g_i

    zero_inv = 0.0 * s_invs[0]
    zero_g = 0.0 * r[0]
    (_, _), g = jax.lax.scan(fwd, (zero_inv, zero_g), (r, s_invs))

    def bwd(w_next, inp):
        g_i, s_inv_i = inp
        g_mod = g_i.at[_SA_X:].add(Ad.T @ w_next[_SA_Y:_SA_X])
        w_i = s_inv_i @ g_mod
        return w_i, w_i

    _, w = jax.lax.scan(bwd, 0.0 * g[0], (g, s_invs), reverse=True)

    du = w[:, _SA_U:_SA_Z]
    dz = w[:, _SA_Z:_SA_NU]
    dnu = w[:, _SA_NU:_SA_Y]
    dy = w[:, _SA_Y:_SA_X]
    dx = w[:, _SA_X:]
    dxz = jnp.concatenate([dx.reshape(-1), du.reshape(-1)])
    dyv = jnp.concatenate([dy.reshape(-1), dnu.reshape(-1)])
    return dxz, dz.reshape(-1), dyv


# --- Condensed-system packing (shared by the "ric" backend) ----------------
#
# Eliminating every x_{t+1} block directly (diagonal pivot Q+beta) leaves a
# 26-wide block-tridiagonal system in [u_t, nu_t, y_t]; these helpers pack
# the RHS into that condensed layout.

def _split_condensed_rhs(qp: StageQP, r1: jnp.ndarray, r4: jnp.ndarray,
                         q_inv: jnp.ndarray):
    """Shared rhs unpacking + condensed y-row shift for the x-eliminated
    backends: returns (c, ru, g, rnu, ry) with
    ry = g - Q~^-1 c + Ad Q~^-1 c_{t-1} [t >= 1]."""
    T = qp.horizon
    Ad = qp.dyn.A
    c = r1[: NX * T].reshape(T, NX)
    ru = r1[NX * T:].reshape(T, NU)
    g = r4[: NX * T].reshape(T, NX)
    rnu = r4[NX * T:].reshape(T, N_MX_PER_STAGE)
    ry = g - q_inv[None] * c
    ry = ry.at[1:].add((Ad @ (q_inv[:, None] * c[:-1].T)).T)
    return c, ru, g, rnu, ry


def _pack_condensed(qp: StageQP, r1: jnp.ndarray, r4: jnp.ndarray,
                    q_inv: jnp.ndarray):
    """rhs -> condensed (T, 26) stage vectors + c (T, 12) x-row rhs."""
    c, ru, _, rnu, ry = _split_condensed_rhs(qp, r1, r4, q_inv)
    return jnp.concatenate([ru, rnu, ry], axis=1), c


# --- Two-level condensed backend ("ric") ------------------------------------
#
# Work-minimal factorization of the condensed 26-wide stage-tridiagonal
# described above: per stage, the [u (12), nu (2)] block
#
#     K_t = [[R~_t, e^T], [e, -delta I]]        (14x14, quasi-definite)
#
# couples to the dual y_t only through F = [-Bd, 0], and all T K_t inverses
# are INDEPENDENT (batchable). Eliminating [u, nu] leaves a pure y-chain
# 12x12 block-tridiagonal with static coupling S = Q~^-1 Ad^T:
#
#     Y'_t = Y_t - Bd (K_t^-1)_uu Bd^T,  Y_t = -dI - Q~^-1 - Ad Q~^-1 Ad^T[t>=1]
#     Yhat_t = Y'_t - S^T Yhat_{t-1}^-1 S        (dual Riccati, sequential)
#
# vs the 26-wide Thomas sweep this cuts the sequential elimination to 12-wide
# inverses (~5x less sequential work) and batches the rest.

_E_SEL_ROWS = ((0, 6), (1, 9))  # Mx selector: e[0, 6] = e[1, 9] = 1
NUN = NU + N_MX_PER_STAGE  # 14

# Foot-split block index sets (PdipmOptions.foot_split). u = [F_L(0:3),
# F_R(3:6), M_L(6:9), M_R(9:12)]; constraint rows touch only their own
# foot's {F, M_y}, the Mx selector pairs M_x with its nu row, and M_z is
# untouched — so the stage blocks decompose EXACTLY (verified: zero
# off-block entries, blockwise inverse == dense inverse to roundoff).
_FS_RIC_BLOCKS = (
    (0, 1, 2, 7), (3, 4, 5, 10),  # per-foot dense SPD [F, M_y]
    (6, 12), (9, 13),             # [M_x, nu] pairs (W-independent)
    (8,), (11,),                  # bare M_z scalars
)
_FS_AUG_BLOCKS = (
    tuple([0, 1, 2, 7] + list(range(12, 20))),   # foot L [F, M_y, z_L(8)]
    tuple([3, 4, 5, 10] + list(range(20, 28))),  # foot R [F, M_y, z_R(8)]
    (6, 28), (9, 29),
    (8,), (11,),
)


def _jacobi_scaled(inverse_fn, k: jnp.ndarray, opts: PdipmOptions):
    """Compute K^-1 for (T, n, n) blocks through a Jacobi-equilibrated form.

    K_hat = D K D with D = rsqrt(|diag K|) has ~unit diagonal, so the
    elimination's pivot growth is bounded by the block's true conditioning
    rather than its raw scale spread (diag entries here span R+beta ~ 1e-5
    to condensed-W ~ 1e8). K^-1 = D K_hat^-1 D exactly; at f64 this is a
    no-op up to roundoff (pinned by tests), at f32 it changes which digits
    survive. `inverse_fn` maps (T, n, n) -> (T, n, n)."""
    if opts.kkt_scale != "jacobi":
        return inverse_fn(k)
    dia = jnp.abs(jnp.diagonal(k, axis1=-2, axis2=-1))
    dsc = jax.lax.rsqrt(jnp.maximum(dia, 1e-30))
    k_hat = k * dsc[..., :, None] * dsc[..., None, :]
    return inverse_fn(k_hat) * dsc[..., :, None] * dsc[..., None, :]


def _blockwise_inverse(k, blocks, inv):
    """Invert (T, n, n) blockwise given exact decoupling; returns dense.

    Algebraically identical to the dense inverse when every off-block entry
    is exactly zero (the foot-split structure); ~(sum n_b^3)/(n^3) of the
    elimination work.
    """
    out = jnp.zeros_like(k)
    for blk in blocks:
        ix = jnp.asarray(blk)
        sub = k[:, ix[:, None], ix[None, :]]
        if len(blk) == 1:
            sub_inv = 1.0 / sub
        else:
            sub_inv = jax.vmap(inv)(sub)
        out = out.at[:, ix[:, None], ix[None, :]].set(sub_inv)
    return out


def _factor_ric(qp: StageQP, w_inv: jnp.ndarray, opts: PdipmOptions):
    T = qp.horizon
    dtype = qp.f.dtype
    Ad, Bd, _ = qp.dyn
    q_inv = 1.0 / (qp.q_diag + opts.beta)

    inv = gauss_jordan_inverse if opts.inv_impl == "gj" else jnp.linalg.inv

    ru = _stage_hessians(qp, w_inv, opts)  # (T, 12, 12) R~
    e = jnp.zeros((N_MX_PER_STAGE, NU), dtype=dtype)
    for r, c in _E_SEL_ROWS:
        e = e.at[r, c].set(1.0)
    k = jnp.zeros((T, NUN, NUN), dtype=dtype)
    k = k.at[:, :NU, :NU].set(ru)
    k = k.at[:, :NU, NU:].set(e.T[None])
    k = k.at[:, NU:, :NU].set(e[None])
    k = k.at[:, NU:, NU:].set(
        -opts.delta * jnp.eye(N_MX_PER_STAGE, dtype=dtype)[None]
    )
    if opts.foot_split:
        k_inv = _jacobi_scaled(
            lambda m: _blockwise_inverse(m, _FS_RIC_BLOCKS, inv), k, opts
        )
    else:
        k_inv = _jacobi_scaled(jax.vmap(inv), k, opts)  # (T, 14, 14)

    y_blk = -opts.delta * jnp.eye(NX, dtype=dtype) - jnp.diag(q_inv)
    adqad = Ad @ jnp.diag(q_inv) @ Ad.T
    yp = jnp.broadcast_to(y_blk, (T, NX, NX)) - jnp.where(
        jnp.arange(T)[:, None, None] >= 1, adqad[None], 0.0
    )
    kuu = k_inv[:, :NU, :NU]
    yp = yp - jnp.einsum("ij,tjk,lk->til", Bd, kuu, Bd)

    s_coup = jnp.diag(q_inv) @ Ad.T  # S = Q~^-1 Ad^T

    def chain(m_prev_inv, yp_t):
        yhat = yp_t - s_coup.T @ m_prev_inv @ s_coup
        yhat_inv = inv(yhat)
        return yhat_inv, yhat_inv

    _, yhat_inv = jax.lax.scan(chain, 0.0 * yp[0], yp)
    return k_inv, yhat_inv, q_inv, s_coup


def _solve_ric(qp: StageQP, factors, r1: jnp.ndarray, r4: jnp.ndarray):
    T = qp.horizon
    Ad, Bd, _ = qp.dyn
    k_inv, yhat_inv, q_inv, s_coup = factors

    r, c = _pack_condensed(qp, r1, r4, q_inv)  # (T, 26), (T, 12)
    r_un = r[:, :NUN]
    r_y = r[:, NUN:]

    # Fold [u, nu] rhs into the y rows: r'_y = r_y - F K^-1 r_un, F = [-Bd, 0].
    kr = jnp.einsum("tij,tj->ti", k_inv, r_un)
    r_y2 = r_y + kr[:, :NU] @ Bd.T

    def fwd(carry, inp):
        prev_inv, g_prev = carry
        r_t, yinv_t = inp
        g_t = r_t - s_coup.T @ (prev_inv @ g_prev)
        return (yinv_t, g_t), g_t

    (_, _), g = jax.lax.scan(
        fwd, (0.0 * yhat_inv[0], 0.0 * r_y2[0]), (r_y2, yhat_inv)
    )

    def bwd(y_next, inp):
        g_t, yinv_t = inp
        y_t = yinv_t @ (g_t - s_coup @ y_next)
        return y_t, y_t

    _, wy = jax.lax.scan(bwd, 0.0 * g[0], (g, yhat_inv), reverse=True)

    # Back-substitute [u, nu]: un_t = K^-1 (r_un - F^T y_t).
    rhs_un = jnp.concatenate([r_un[:, :NU] + wy @ Bd, r_un[:, NU:]], axis=1)
    un = jnp.einsum("tij,tj->ti", k_inv, rhs_un)

    # x recovery: x_{t+1} = Q~^-1 (c_t - y_t + Ad^T y_{t+1}).
    xs = q_inv[None] * (c - wy)
    xs = xs.at[:-1].add(q_inv[None] * (wy[1:] @ Ad))

    dxz = jnp.concatenate([xs.reshape(-1), un[:, :NU].reshape(-1)])
    dyv = jnp.concatenate([wy.reshape(-1), un[:, NU:].reshape(-1)])
    return dxz, dyv


# --- Two-level augmented backend ("ric_aug") ---------------------------------
#
# The "ric" split applied to the AUGMENTED (no G^T W^-1 G condensation) form:
# per stage the [u (12), z (16), nu (2)] block
#
#     K_t = [[R+beta, G_u^T, e^T], [G_u, -W_t, 0], [e, 0, -delta I]]  (30x30)
#
# keeps every extreme scale (W up to ~1e8, -delta = -1e-8) on its own
# diagonal where pivoted elimination handles it cleanly — the f32-robustness
# property of "tridiag_aug" — while all T K_t inverses stay independent
# (batchable) and the sequential part is the same 12-wide y-chain as
# "ric". Accuracy class of tridiag_aug at a fraction of its work. The fused
# CUDA solver (`ops/pdipm_cuda.py`) implements exactly this backend with
# foot_split=True.

N_KA = NU + N_INEQ_PER_STAGE + N_MX_PER_STAGE  # 30


def _factor_ric_aug(qp: StageQP, w_diag: jnp.ndarray, opts: PdipmOptions):
    """w_diag: (T, 16) = Sigma^-1 + delta per inequality row."""
    T = qp.horizon
    dtype = qp.f.dtype
    Ad, Bd, _ = qp.dyn
    q_inv = 1.0 / (qp.q_diag + opts.beta)

    inv = gauss_jordan_inverse if opts.inv_impl == "gj" else jnp.linalg.inv

    e = jnp.zeros((N_MX_PER_STAGE, NU), dtype=dtype)
    for r, c in _E_SEL_ROWS:
        e = e.at[r, c].set(1.0)
    z0 = NU
    n0 = NU + N_INEQ_PER_STAGE
    k = jnp.zeros((T, N_KA, N_KA), dtype=dtype)
    k = k.at[:, :NU, :NU].set(jnp.diag(qp.r_diag + opts.beta)[None])
    k = k.at[:, :NU, z0:n0].set(qp.g_u.T[None])
    k = k.at[:, z0:n0, :NU].set(qp.g_u[None])
    zi = jnp.arange(N_INEQ_PER_STAGE)
    k = k.at[:, z0 + zi, z0 + zi].set(-w_diag)
    k = k.at[:, :NU, n0:].set(e.T[None])
    k = k.at[:, n0:, :NU].set(e[None])
    k = k.at[:, n0:, n0:].set(
        -opts.delta * jnp.eye(N_MX_PER_STAGE, dtype=dtype)[None]
    )
    if opts.foot_split:
        k_inv = _jacobi_scaled(
            lambda m: _blockwise_inverse(m, _FS_AUG_BLOCKS, inv), k, opts
        )
    else:
        k_inv = _jacobi_scaled(jax.vmap(inv), k, opts)  # (T, 30, 30)

    y_blk = -opts.delta * jnp.eye(NX, dtype=dtype) - jnp.diag(q_inv)
    adqad = Ad @ jnp.diag(q_inv) @ Ad.T
    yp = jnp.broadcast_to(y_blk, (T, NX, NX)) - jnp.where(
        jnp.arange(T)[:, None, None] >= 1, adqad[None], 0.0
    )
    kuu = k_inv[:, :NU, :NU]
    yp = yp - jnp.einsum("ij,tjk,lk->til", Bd, kuu, Bd)

    s_coup = jnp.diag(q_inv) @ Ad.T

    def chain(m_prev_inv, yp_t):
        yhat = yp_t - s_coup.T @ m_prev_inv @ s_coup
        yhat_inv = inv(yhat)
        return yhat_inv, yhat_inv

    _, yhat_inv = jax.lax.scan(chain, 0.0 * yp[0], yp)
    return k_inv, yhat_inv, q_inv, s_coup


def _solve_ric_aug(qp: StageQP, factors, r1, r_z, r4):
    """Returns (dxz (nz,), dz (ni,), dyv (ne,)) like `_solve_tridiag_aug`."""
    T = qp.horizon
    Ad, Bd, _ = qp.dyn
    k_inv, yhat_inv, q_inv, s_coup = factors

    c, ru, _, rnu, ry = _split_condensed_rhs(qp, r1, r4, q_inv)
    rz = r_z.reshape(T, N_INEQ_PER_STAGE)

    r_un = jnp.concatenate([ru, rz, rnu], axis=1)  # (T, 30)
    kr = jnp.einsum("tij,tj->ti", k_inv, r_un)
    r_y2 = ry + kr[:, :NU] @ Bd.T

    def fwd(carry, inp):
        prev_inv, g_prev = carry
        r_t, yinv_t = inp
        g_t = r_t - s_coup.T @ (prev_inv @ g_prev)
        return (yinv_t, g_t), g_t

    (_, _), gg = jax.lax.scan(
        fwd, (0.0 * yhat_inv[0], 0.0 * r_y2[0]), (r_y2, yhat_inv)
    )

    def bwd(y_next, inp):
        g_t, yinv_t = inp
        y_t = yinv_t @ (g_t - s_coup @ y_next)
        return y_t, y_t

    _, wy = jax.lax.scan(bwd, 0.0 * gg[0], (gg, yhat_inv), reverse=True)

    rhs_un = jnp.concatenate(
        [r_un[:, :NU] + wy @ Bd, r_un[:, NU:]], axis=1
    )
    un = jnp.einsum("tij,tj->ti", k_inv, rhs_un)

    xs = q_inv[None] * (c - wy)
    xs = xs.at[:-1].add(q_inv[None] * (wy[1:] @ Ad))

    dxz = jnp.concatenate([xs.reshape(-1), un[:, :NU].reshape(-1)])
    dz = un[:, NU: NU + N_INEQ_PER_STAGE].reshape(-1)
    dyv = jnp.concatenate(
        [wy.reshape(-1), un[:, NU + N_INEQ_PER_STAGE:].reshape(-1)]
    )
    return dxz, dz, dyv


# --- Scaled Riccati-core augmented backend ("ric_aug_core") ------------------
#
# KKT equilibration and the 12-wide Riccati-core elimination composed into
# one factorization. Scale the inputs u = C u_hat with C = diag(1/sqrt(R+beta)):
# the augmented stage block becomes
#
#     K_hat = [[I, V^T], [V, -Wfull]],   V = [G_u C; E C] (18 x 12),
#     Wfull = diag(w_diag (16), delta, delta)
#
# whose u block is the IDENTITY — eliminating u first is now exact (no pivot
# search: the Schur complement S = -(Wfull + V V^T) is symmetric NEGATIVE
# definite, so the remaining elimination is Cholesky-stable in natural
# order). Unlike the condensed G^T W^-1 G (which SUMS extreme W scales into
# dense entries and is what costs the condensed kernels their f32 tails),
# here every extreme scale stays on its own diagonal of S: the off-diagonal
# entries of S are pure O(1) geometry (g_i . g_j), W appears only on the
# diagonal — the f32-robustness property of the augmented form survives the
# elimination. Per-stage factor work drops from one 30-wide (or two 12-wide
# pivoted, foot-split) GJ to two 8-wide no-pivot GJs: V's z rows touch only
# u columns {F, M_y} of their OWN foot and the Mx/nu rows only column M_x,
# so S is block-diagonal [8x8 foot L, 8x8 foot R, scalar, scalar] exactly.
#
#     K_hat^-1 = [[I + V^T S^-1 V,  -V^T S^-1],
#                 [-S^-1 V,          S^-1    ]],   K^-1 = D K_hat^-1 D
#
# with D = blkdiag(C, I). Algebraically identical to "ric_aug"/"tridiag_aug"
# (same regularized system, exact block elimination), so f64 iterates match
# the golden solver to roundoff; reference rule per
# `sparse_pdipm_solver.py:404-439`.

N_VC = N_INEQ_PER_STAGE + N_MX_PER_STAGE  # 18 coupled constraint rows

# S block structure (exact): per-foot z rows + the two nu scalars.
_CORE_S_BLOCKS = (tuple(range(8)), tuple(range(8, 16)), (16,), (17,))


def _core_vmat(qp: StageQP, opts: PdipmOptions):
    """(18, 12) scaled constraint matrix V = [G_u C; E C] and c_u = diag(C)."""
    dtype = qp.f.dtype
    c_u = jax.lax.rsqrt(qp.r_diag + opts.beta)
    v = jnp.zeros((N_VC, NU), dtype=dtype)
    v = v.at[:N_INEQ_PER_STAGE].set(qp.g_u * c_u[None, :])
    for r, c in _E_SEL_ROWS:
        v = v.at[N_INEQ_PER_STAGE + r, c].set(c_u[c])
    return v, c_u


def _factor_ric_aug_core(qp: StageQP, w_diag: jnp.ndarray, opts: PdipmOptions):
    """w_diag: (T, 16) = Sigma^-1 + delta per inequality row."""
    T = qp.horizon
    dtype = qp.f.dtype
    Ad, Bd, _ = qp.dyn
    q_inv = 1.0 / (qp.q_diag + opts.beta)

    inv = gauss_jordan_inverse if opts.inv_impl == "gj" else jnp.linalg.inv

    v, c_u = _core_vmat(qp, opts)
    wfull = jnp.concatenate(
        [w_diag, jnp.full((T, N_MX_PER_STAGE), opts.delta, dtype=dtype)],
        axis=1,
    )  # (T, 18)
    vvt = v @ v.T  # (18, 18) static across stages
    s = -(vvt[None] + jnp.zeros((T, 1, 1), dtype=dtype))
    ii = jnp.arange(N_VC)
    s = s.at[:, ii, ii].add(-wfull)
    if opts.foot_split:
        s_inv = _blockwise_inverse(s, _CORE_S_BLOCKS, inv)
    else:
        s_inv = jax.vmap(inv)(s)  # (T, 18, 18) negative definite

    # kuu_hat = I + V^T S^-1 V  (12x12, SPD); y-chain uses the C-conjugated
    # coupling Bd_hat = Bd C so no unscaled kuu is ever materialized.
    vs = jnp.einsum("tij,jk->tik", s_inv, v)  # (T, 18, 12) = S^-1 V
    kuu_hat = jnp.eye(NU, dtype=dtype)[None] + jnp.einsum("ji,tjk->tik", v, vs)
    bd_hat = Bd * c_u[None, :]

    y_blk = -opts.delta * jnp.eye(NX, dtype=dtype) - jnp.diag(q_inv)
    adqad = Ad @ jnp.diag(q_inv) @ Ad.T
    yp = jnp.broadcast_to(y_blk, (T, NX, NX)) - jnp.where(
        jnp.arange(T)[:, None, None] >= 1, adqad[None], 0.0
    )
    yp = yp - jnp.einsum("ij,tjk,lk->til", bd_hat, kuu_hat, bd_hat)

    s_coup = jnp.diag(q_inv) @ Ad.T

    def chain(m_prev_inv, yp_t):
        yhat = yp_t - s_coup.T @ m_prev_inv @ s_coup
        yhat_inv = inv(yhat)
        return yhat_inv, yhat_inv

    _, yhat_inv = jax.lax.scan(chain, 0.0 * yp[0], yp)
    return s_inv, v, c_u, kuu_hat, bd_hat, yhat_inv, q_inv, s_coup


def _core_kinv_apply(s_inv, v, r_uh, r_zn):
    """K_hat^-1 [r_uh; r_zn] -> (du_hat (T,12), dzn (T,18))."""
    t = jnp.einsum("tij,tj->ti", s_inv, jnp.einsum("ij,tj->ti", v, r_uh) - r_zn)
    du_hat = r_uh + jnp.einsum("ji,tj->ti", v, t)
    return du_hat, -t


def _solve_ric_aug_core(qp: StageQP, factors, r1, r_z, r4):
    """Returns (dxz (nz,), dz (ni,), dyv (ne,)) like `_solve_ric_aug`."""
    T = qp.horizon
    Ad, Bd, _ = qp.dyn
    s_inv, v, c_u, kuu_hat, bd_hat, yhat_inv, q_inv, s_coup = factors

    c, ru, _, rnu, ry = _split_condensed_rhs(qp, r1, r4, q_inv)
    rz = r_z.reshape(T, N_INEQ_PER_STAGE)

    r_uh = ru * c_u[None, :]
    r_zn = jnp.concatenate([rz, rnu], axis=1)  # (T, 18)

    # Fold the [u, z, nu] rhs into the y rows: r'_y = ry + (K^-1 r)_u Bd^T
    # = ry + (K_hat^-1 r_hat)_u Bd_hat^T.
    du_hat0, _ = _core_kinv_apply(s_inv, v, r_uh, r_zn)
    r_y2 = ry + du_hat0 @ bd_hat.T

    def fwd(carry, inp):
        prev_inv, g_prev = carry
        r_t, yinv_t = inp
        g_t = r_t - s_coup.T @ (prev_inv @ g_prev)
        return (yinv_t, g_t), g_t

    (_, _), gg = jax.lax.scan(
        fwd, (0.0 * yhat_inv[0], 0.0 * r_y2[0]), (r_y2, yhat_inv)
    )

    def bwd(y_next, inp):
        g_t, yinv_t = inp
        y_t = yinv_t @ (g_t - s_coup @ y_next)
        return y_t, y_t

    _, wy = jax.lax.scan(bwd, 0.0 * gg[0], (gg, yhat_inv), reverse=True)

    # Back-substitute [u, z, nu]: rhs_u picks up the dual coupling F^T y.
    r_uh2 = r_uh + wy @ bd_hat
    du_hat, dzn = _core_kinv_apply(s_inv, v, r_uh2, r_zn)
    du = du_hat * c_u[None, :]

    xs = q_inv[None] * (c - wy)
    xs = xs.at[:-1].add(q_inv[None] * (wy[1:] @ Ad))

    dxz = jnp.concatenate([xs.reshape(-1), du.reshape(-1)])
    dz = dzn[:, :N_INEQ_PER_STAGE].reshape(-1)
    dyv = jnp.concatenate(
        [wy.reshape(-1), dzn[:, N_INEQ_PER_STAGE:].reshape(-1)]
    )
    return dxz, dz, dyv


# ---------------------------------------------------------------------------
# Main iteration.
# ---------------------------------------------------------------------------

_PURE_BACKENDS = ("tridiag", "tridiag_aug", "dense", "ric", "ric_aug",
                  "ric_aug_core")


def _iteration(qp: StageQP, st: PdipmState, opts: PdipmOptions):
    """One Mehrotra predictor-corrector step (reference rule, reduced solve)."""
    # Validate here, not only in the controller's menu: the dispatch below
    # ends in an `else` (tridiag), and a stale/typo'd backend string (e.g.
    # the removed "bcr") silently timing the wrong solver is exactly the
    # bug class that mislabels benchmarks.
    if opts.backend not in _PURE_BACKENDS:
        raise ValueError(
            f"unknown pdipm backend {opts.backend!r}; expected one of "
            f"{_PURE_BACKENDS}"
        )
    x, s, z, y = st
    ni = qp.n_ineq
    hd = qps.h_diag(qp)
    d = qps.d_vec(qp)
    b = qps.b_vec(qp)

    rx = hd * x + qp.f + qps.gT_matvec(qp, z) + qps.aT_matvec(qp, y)
    re = qps.a_matvec(qp, x) - b
    rs = qps.g_matvec(qp, x) + s - d
    mu = jnp.dot(s, z) / ni

    sigma_d = z / s + opts.delta  # Sigma diagonal
    if opts.sigma_cap > 0.0:
        sigma_d = jnp.minimum(sigma_d, opts.sigma_cap)

    if opts.backend in ("tridiag_aug", "ric_aug", "ric_aug_core"):
        w_diag = 1.0 / sigma_d + opts.delta  # W = Sigma^-1 + delta
        if opts.backend == "ric_aug_core":
            factors = _factor_ric_aug_core(
                qp, w_diag.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve_aug = functools.partial(_solve_ric_aug_core, qp, factors)
        elif opts.backend == "ric_aug":
            factors = _factor_ric_aug(
                qp, w_diag.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve_aug = functools.partial(_solve_ric_aug, qp, factors)
        else:
            factors = _factor_tridiag_aug(
                qp, w_diag.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve_aug = functools.partial(_solve_tridiag_aug, qp, factors)

        def reduced_solve(r1, r2, r3, r4, refine=opts.refine_steps):
            r_z = r3 - r2 / sigma_d
            dx, dz, dy = solve_aug(r1, r_z, r4)
            for _ in range(refine):
                if opts.refine_residual == "df":
                    # Compensated (double-float) residual: see
                    # PdipmOptions.refine_residual / ops/df.py.
                    from biped_pympc_tpu.ops import df as dfm

                    e1, ezr, e4 = dfm.residual_aug(
                        qp, hd, w_diag, opts.beta, opts.delta,
                        dx, dz, dy, r1, r_z, r4)
                else:
                    m1 = (hd + opts.beta) * dx + qps.gT_matvec(qp, dz) \
                        + qps.aT_matvec(qp, dy)
                    mz = qps.g_matvec(qp, dx) - w_diag * dz
                    m4 = qps.a_matvec(qp, dx) - opts.delta * dy
                    e1, ezr, e4 = r1 - m1, r_z - mz, r4 - m4
                ex, ez, ey = solve_aug(e1, ezr, e4)
                dx, dz, dy = dx + ex, dz + ez, dy + ey
            ds = (r2 - dz) / sigma_d
            return dx, ds, dz, dy

    else:
        w_inv = sigma_d / (1.0 + opts.delta * sigma_d)  # (Sigma^-1 + delta)^-1
        if opts.backend == "dense":
            factors = _factor_dense(
                qp, w_inv.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve = functools.partial(_solve_dense, qp, factors)
        elif opts.backend == "ric":
            factors = _factor_ric(
                qp, w_inv.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve = functools.partial(_solve_ric, qp, factors)
        else:
            factors = _factor_tridiag(
                qp, w_inv.reshape(qp.horizon, N_INEQ_PER_STAGE), opts
            )
            solve = functools.partial(_solve_tridiag, qp, factors)

        def reduced_mv(dx, dy):
            """Matvec of the reduced KKT [[H+bI+G^T W^-1 G, A^T], [A, -dI]]."""
            m1 = (hd + opts.beta) * dx + qps.gT_matvec(
                qp, w_inv * qps.g_matvec(qp, dx)
            ) + qps.aT_matvec(qp, dy)
            m2 = qps.a_matvec(qp, dx) - opts.delta * dy
            return m1, m2

        def reduced_solve(r1, r2, r3, r4, refine=opts.refine_steps):
            r1_hat = r1 + qps.gT_matvec(qp, w_inv * (r3 - r2 / sigma_d))
            dx, dy = solve(r1_hat, r4)
            for _ in range(refine):
                m1, m2 = reduced_mv(dx, dy)
                ex, ey = solve(r1_hat - m1, r4 - m2)
                dx, dy = dx + ex, dy + ey
            dz = w_inv * (qps.g_matvec(qp, dx) + r2 / sigma_d - r3)
            ds = (r2 - dz) / sigma_d
            return dx, ds, dz, dy

    zeros_z = jnp.zeros_like(rx)
    zeros_i = jnp.zeros_like(s)
    zeros_e = jnp.zeros_like(re)

    combined = opts.corrector_form == "combined"
    sum_refine = opts.corrector_form == "sum_refine"

    # Affine (predictor) direction. In the "combined"/"sum_refine" forms
    # per-solve refinement is skipped (the final direction is refined as a
    # whole, or the solve only feeds sigma and the ds*dz products).
    dx_a, ds_a, dz_a, dy_a = reduced_solve(
        -rx, -(s * z) / s, -rs, -re,
        refine=0 if (combined or sum_refine) else opts.refine_steps,
    )
    alpha_ap = _frac_to_boundary(s, ds_a, opts)
    alpha_ad = _frac_to_boundary(z, dz_a, opts)

    mu_aff = jnp.dot(s + alpha_ap * ds_a, z + alpha_ad * dz_a) / ni
    sigma = (mu_aff / mu) ** 3

    # Corrector direction.
    rc = s * z + ds_a * dz_a - sigma * mu
    if combined:
        # One refined solve of the summed rhs — identical to
        # refined(affine) + refined(corrector) by linearity of the
        # refinement map, at one fewer refined solve per iteration. NOTE
        # the reference's corrector rhs keeps the s*z term even though the
        # affine rhs already has it (`sparse_pdipm_solver.py:476-486`), so
        # the sum is -(s*z + rc)/s, not the textbook -rc/s.
        dx, ds, dz, dy = reduced_solve(-rx, -(s * z + rc) / s, -rs, -re)
    elif sum_refine:
        dx_c, ds_c, dz_c, dy_c = reduced_solve(
            zeros_z, -rc / s, zeros_i, zeros_e, refine=0
        )
        dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c
        # Refine the summed direction against the full 4-row KKT residual
        # (rows: stationarity; Sigma ds + dz; G dx + ds - delta dz;
        # A dx - delta dy). The correction rhs is small, so the mixed
        # scales that sink the "combined" form never enter a large solve.
        r1s, r2s = -rx, -(s * z + rc) / s
        r3s, r4s = -rs, -re
        for _ in range(opts.refine_steps):
            m1 = (hd + opts.beta) * dx + qps.gT_matvec(qp, dz) \
                + qps.aT_matvec(qp, dy)
            m2 = sigma_d * ds + dz
            m3 = qps.g_matvec(qp, dx) + ds - opts.delta * dz
            m4 = qps.a_matvec(qp, dx) - opts.delta * dy
            ex, es, ez, ey = reduced_solve(
                r1s - m1, r2s - m2, r3s - m3, r4s - m4, refine=0
            )
            dx, ds, dz, dy = dx + ex, ds + es, dz + ez, dy + ey
    else:
        dx_c, ds_c, dz_c, dy_c = reduced_solve(
            zeros_z, -rc / s, zeros_i, zeros_e,
            refine=0 if opts.corrector_form == "aff_ref"
            else opts.refine_steps,
        )
        dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c
    alpha_p = _frac_to_boundary(s, ds, opts)
    alpha_d = _frac_to_boundary(z, dz, opts)

    x = x + alpha_p * dx
    s = jnp.maximum(s + alpha_p * ds, opts.sz_floor)
    z = jnp.maximum(z + alpha_d * dz, opts.sz_floor)
    y = y + alpha_d * dy

    residuals = jnp.stack(
        [
            jnp.linalg.norm(rx),
            jnp.linalg.norm(rs),
            jnp.linalg.norm(re),
            jnp.dot(s, z) / ni,
        ]
    )
    return PdipmState(x, s, z, y), residuals


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions(),
          state: PdipmState | None = None) -> PdipmResult:
    """Run `opts.iterations` fixed Newton steps on a single env's QP.

    vmap over a batch of StageQP pytrees for the batched solver. The loop is a
    `lax.fori_loop` — compiled once, no per-iteration dispatch.
    """
    if opts.refine_residual == "df":
        if opts.backend not in ("tridiag_aug", "ric_aug", "ric_aug_core"):
            raise ValueError(
                "refine_residual='df' is implemented for the aug backends "
                f"only (got backend={opts.backend!r}); see "
                "PdipmOptions.refine_residual"
            )
        if opts.corrector_form == "sum_refine":
            # sum_refine's refinement runs in its own outer full-KKT loop
            # with plain f32 residuals — df would be silently ignored.
            raise ValueError(
                "refine_residual='df' is not implemented for "
                "corrector_form='sum_refine' (its refinement loop uses the "
                "full-KKT residual, not reduced_solve's)"
            )
    if state is None:
        state = init_state(qp)

    def body(_, carry):
        st, _ = carry
        return _iteration(qp, st, opts)

    residuals0 = 0.0 * qp.f[:4]
    st, residuals = jax.lax.fori_loop(
        0, opts.iterations, body, (state, residuals0)
    )
    return PdipmResult(st.x, st.s, st.z, st.y, residuals)


def kkt_error(qp: StageQP, res: PdipmResult) -> jnp.ndarray:
    """(4,) TRUE KKT residual inf-norms of a solution — ONE operator apply,
    no factorization. Single env; vmap over the batch.

    Components: [||H x + f + G^T z + A^T y||_inf, ||G x + s - d||_inf,
    ||A x - b||_inf, ||s o z||_inf]. Unlike `PdipmResult.residuals` (2-norms
    evaluated at the START of the final Newton step — one step stale, and
    computed INSIDE the solver whose f32 condensation error they cannot
    see), this measures the returned iterate directly under the exact
    operator, so condensation loss shows up as stationarity/complementarity
    residual; the role OSQP's eps_abs=1e-12 cross-check plays in the
    reference
    (`mpc_controller_osqp.py:85`)."""
    hd = qps.h_diag(qp)
    rx = hd * res.x + qp.f + qps.gT_matvec(qp, res.z) + qps.aT_matvec(qp, res.y)
    re = qps.a_matvec(qp, res.x) - qps.b_vec(qp)
    rs = qps.g_matvec(qp, res.x) + res.s - qps.d_vec(qp)
    comp = res.s * res.z
    inf = lambda v: jnp.max(jnp.abs(v))
    return jnp.stack([inf(rx), inf(rs), inf(re), inf(comp)])


def solve_adaptive_batch(qp, opts: PdipmOptions = PdipmOptions(),
                         tol: float = 1e-2) -> PdipmResult:
    """Adaptive-iteration batched solve.

    qp: StageQP pytree with a LEADING batch axis. Runs vmapped
    `opts.iterations_per_launch`-step chunks inside a `lax.while_loop`,
    stopping when every env's residual criterion max(||rx||, ||rs||,
    ||re||, mu) is below `tol` or at EXACTLY the `opts.iterations` cap (a
    non-divisible remainder runs as one final shorter chunk). The
    criterion is evaluated at the start of a Newton step (one iteration
    stale, conservative). One stop decision gates the whole batch."""
    chunk = min(opts.iterations_per_launch, opts.iterations)
    n_full, rem = divmod(opts.iterations, chunk)
    chunk_opts = opts._replace(iterations=chunk)
    state0 = jax.vmap(init_state)(qp)

    def cond(carry):
        k, st, res = carry
        return jnp.logical_and(k < n_full, jnp.max(res) > tol)

    def body(carry):
        k, st, _ = carry
        r = jax.vmap(lambda q, s: solve(q, chunk_opts, s))(qp, st)
        return k + 1, PdipmState(r.x, r.s, r.z, r.y), r.residuals

    big = jnp.full((qp.f.shape[0], 4), jnp.inf, qp.f.dtype)
    _, st, res = jax.lax.while_loop(cond, body, (0, state0, big))
    if rem:
        # Exact cap: one final rem-iteration chunk, skipped if converged.
        def run_rem(args):
            st, _ = args
            r = jax.vmap(
                lambda q, s: solve(q, opts._replace(iterations=rem), s)
            )(qp, st)
            return PdipmState(r.x, r.s, r.z, r.y), r.residuals

        st, res = jax.lax.cond(
            jnp.max(res) > tol, run_rem, lambda args: args, (st, res)
        )
    return PdipmResult(x=st.x, s=st.s, z=st.z, y=st.y, residuals=res)
