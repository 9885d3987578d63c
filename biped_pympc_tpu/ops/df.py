"""Double-float (compensated) arithmetic for f32 refinement residuals.

In an f32 solve the refinement residual r - K d — a catastrophic cancellation: r and K d agree to ~all
their f32 digits, and what survives the subtraction is the rounding error
of the f32 matvec itself — is computed here with error-free
transformations (Knuth two_sum, Dekker/Veltkamp two_prod), giving the
~2x-working-precision residual that standard mixed-precision iterative
refinement assumes (the reference sidesteps the question by running f64 everywhere, `mpc_controller_cusadi.py:67-71`).

Each output component accumulates its FULL linear combination
r_i - sum_j K_ij d_j in one compensated (value, error) pair, so
cancellation is exact until the final fold; the folded f32 result then
carries full relative precision because the residual itself is small.

The EFTs rely on IEEE f32 add/mul semantics, which XLA preserves for
TRACED values (no unsafe reassociation by default); `tests/test_pdipm.py::
test_df_residual_accuracy` pins the compiled behavior against f64.
HAZARD (measured): XLA's CONSTANT FOLDER algebraically simplifies the
EFTs away — a zero-argument jit closing over the inputs as constants
returns the plain-f32 result (rel err 8e-3 vs 4e-8 traced). Always pass
the operands as jit arguments (the solver does).
"""

from __future__ import annotations

import jax.numpy as jnp

# Veltkamp split constant for float32 (24-bit significand): 2^12 + 1.
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free a + b: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, e) with p = fl(a*b), p + e = a*b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class Acc:
    """Compensated accumulator: one (sum, error) pair per output element.

    Every `add`/`add_prod` keeps the exact rounding error of the running
    sum (Ogita-Rump-Oishi dot2 structure), so the folded `value()` is the
    true sum to ~2x f32 precision.
    """

    def __init__(self, init):
        self.s = jnp.asarray(init)
        self.c = jnp.zeros_like(self.s)

    def add(self, x):
        self.s, e = two_sum(self.s, jnp.broadcast_to(x, self.s.shape))
        self.c = self.c + e
        return self

    def add_prod(self, a, b, sign=1.0):
        """Accumulate sign * a * b (elementwise, broadcastable)."""
        p, pe = two_prod(
            jnp.broadcast_to(a * sign, self.s.shape),
            jnp.broadcast_to(b, self.s.shape),
        )
        self.s, se = two_sum(self.s, p)
        self.c = self.c + se + pe
        return self

    def add_matmul(self, v, m, sign=1.0):
        """Accumulate sign * (v @ m): v (T, k), m (k, n) into (T, n).

        The reduction axis k is small (<= 16) and static, so the loop
        unrolls at trace time into elementwise EFT ops.
        """
        k = m.shape[0]
        for j in range(k):
            self.add_prod(v[:, j:j + 1], m[j][None, :], sign)
        return self

    def value(self):
        return self.s + self.c


def residual_aug(qp, hd, w_diag, beta, delta, dx, dz, dy, r1, r_z, r4):
    """Compensated refinement residual of the augmented reduced system.

    Mirrors the f32 residual in `pdipm.reduced_solve` (aug backends):
        e1 = r1 - [(hd + beta) dx + G^T dz + A^T dy]
        ez = r_z - [G dx - W dz]
        e4 = r4 - [A dx - delta dy]
    with every output component accumulated as ONE compensated linear
    combination (matrix data = the stored f32 qp/w_diag leaves; the
    hd + beta matrix entry is itself compensated via two_sum so the
    residual targets the exact real-arithmetic system over that data).
    Single env; vmapped by the caller. Returns (e1, ez, e4) folded to f32.
    """
    from biped_pympc_tpu.ops.qp import NU, NX, N_INEQ_PER_STAGE, _MX_COLS

    T = qp.horizon
    Ad, Bd = qp.dyn.A, qp.dyn.B
    g_u = qp.g_u
    dx_x = dx[: NX * T].reshape(T, NX)
    dx_u = dx[NX * T:].reshape(T, NU)
    dz_s = dz.reshape(T, N_INEQ_PER_STAGE)
    y_dyn = dy[: NX * T].reshape(T, NX)
    y_mx = dy[NX * T:].reshape(T, 2)
    y_next = jnp.concatenate(
        [y_dyn[1:], jnp.zeros((1, NX), dy.dtype)], axis=0)

    # hd + beta compensated (beta underflows against the large Q entries).
    hb, hb_err = two_sum(hd, jnp.asarray(beta, hd.dtype))
    q_diag, q_err = hb[: NX * T].reshape(T, NX), hb_err[: NX * T].reshape(T, NX)
    r_diag, r_err = hb[NX * T:].reshape(T, NU), hb_err[NX * T:].reshape(T, NU)

    r1_x = r1[: NX * T].reshape(T, NX)
    r1_u = r1[NX * T:].reshape(T, NU)

    # e1, x rows: r1_x - (q+beta) dx_x - y_dyn + y_next @ Ad
    a1x = Acc(r1_x)
    a1x.add_prod(q_diag, dx_x, -1.0)
    a1x.add_prod(q_err, dx_x, -1.0)
    a1x.add(-y_dyn)
    a1x.add_matmul(y_next, Ad)

    # e1, u rows: r1_u - (r+beta) dx_u - dz_s @ g_u + y_dyn @ Bd - y_mx(cols)
    a1u = Acc(r1_u)
    a1u.add_prod(r_diag, dx_u, -1.0)
    a1u.add_prod(r_err, dx_u, -1.0)
    a1u.add_matmul(dz_s, g_u, -1.0)
    a1u.add_matmul(y_dyn, Bd)
    y_mx_full = (
        jnp.zeros((T, NU), dy.dtype)
        .at[:, _MX_COLS[0]].set(y_mx[:, 0])
        .at[:, _MX_COLS[1]].set(y_mx[:, 1])
    )
    a1u.add(-y_mx_full)

    # ez: r_z - dx_u @ g_u^T + W dz
    az = Acc(r_z.reshape(T, N_INEQ_PER_STAGE))
    az.add_matmul(dx_u, g_u.T, -1.0)
    az.add_prod(w_diag.reshape(T, N_INEQ_PER_STAGE), dz_s)

    # e4, dynamics rows: r4_dyn - dx_x + prev @ Ad^T + dx_u @ Bd^T + delta dy
    prev = jnp.concatenate(
        [jnp.zeros((1, NX), dx.dtype), dx_x[:-1]], axis=0)
    r4_dyn = r4[: NX * T].reshape(T, NX)
    r4_mx = r4[NX * T:].reshape(T, 2)
    a4 = Acc(r4_dyn)
    a4.add(-dx_x)
    a4.add_matmul(prev, Ad.T)
    a4.add_matmul(dx_u, Bd.T)
    a4.add_prod(jnp.asarray(delta, dy.dtype), y_dyn)

    # e4, Mx rows: r4_mx - dx_u[:, mx] + delta dy_mx
    a4m = Acc(r4_mx)
    a4m.add(-dx_u[:, list(_MX_COLS)])
    a4m.add_prod(jnp.asarray(delta, dy.dtype), y_mx)

    e1 = jnp.concatenate([a1x.value().reshape(-1), a1u.value().reshape(-1)])
    ez = az.value().reshape(-1)
    e4 = jnp.concatenate([a4.value().reshape(-1), a4m.value().reshape(-1)])
    return e1, ez, e4
