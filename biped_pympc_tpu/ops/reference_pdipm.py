"""Golden CPU PDIPM — exact re-implementation of the reference update rule.

This NumPy float64 solver reproduces, step for step, the Mehrotra
predictor-corrector iteration that the reference unrolls into a CasADi SX graph
(`/root/reference/biped_pympc/casadi/sparse_pdipm_solver.py:357-534`):

  * full augmented KKT [[Q+bI, 0, G^T, A^T], [0, S^-1 Z + dI, I, 0],
                        [G, I, -dI, 0], [A, 0, 0, -dI]] with beta=delta=1e-8
  * affine rhs [-rx, -S^-1(s*z), -rs, -re]; LDL-equivalent direct solve
  * fraction-to-boundary 0.99 with alpha floor 1e-12 (`:460-467,495-502`)
  * sigma = (mu_aff / mu)^3 Mehrotra centering (`:469-474`)
  * corrector rhs [0, -S^-1(s*z + ds_aff*dz_aff - sigma mu 1), 0, 0] (`:476-486`)
  * x,s <- + alpha_pri * d ; z,y <- + alpha_dual * d ; s,z clamped >= 1e-8

It is the correctness oracle for the batched JAX and fused solvers (the role OSQP
and the CPU CasADi backend play in the reference,
`mpc_controller_osqp.py` / `mpc_controller_casadi.py`). It is deliberately
unbatched and unoptimized.
"""

from __future__ import annotations

import numpy as np


def initialize_variables(G: np.ndarray, d: np.ndarray, n_eq: int, x0=None):
    """Init per the shipped CUDA path (`mpc_controller_cusadi.py:138-141`):
    x = 0, s = max(d - G x, 1), z = 1, y = 1.

    (Note: the unused helper `sparse_pdipm_solver.py:537-558` uses y = 0; the
    shipped runtime uses y = 1 — we match the runtime.)
    """
    nz = G.shape[1]
    x = np.zeros(nz) if x0 is None else np.array(x0, dtype=np.float64)
    s = np.maximum(d - G @ x, 1.0)
    z = np.ones(G.shape[0])
    y = np.ones(n_eq)
    return x, s, z, y


def solve(
    H: np.ndarray,
    f: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    G: np.ndarray,
    d: np.ndarray,
    x: np.ndarray,
    s: np.ndarray,
    z: np.ndarray,
    y: np.ndarray,
    iterations: int = 20,
    beta: float = 1e-8,
    delta: float = 1e-8,
    trace: bool = False,
):
    """Run `iterations` Mehrotra steps; returns (x, s, z, y, residuals).

    residuals = [||rx||, ||rs||, ||re||, mu] of the last iteration, matching
    the reference output (`sparse_pdipm_solver.py:526-530`). With trace=True
    additionally returns the list of per-iteration (x, s, z, y).
    """
    nz = H.shape[0]
    ni = G.shape[0]
    ne = A.shape[0]
    dim = nz + 2 * ni + ne
    history = []
    residuals = np.zeros(4)

    for _ in range(iterations):
        rx = H @ x + f + G.T @ z + A.T @ y
        re = A @ x - b
        rs = G @ x + s - d
        mu = float(s @ z) / ni

        sigma_diag = z / s + delta  # S^-1 Z + delta I
        KKT = np.zeros((dim, dim))
        KKT[:nz, :nz] = H + beta * np.eye(nz)
        KKT[:nz, nz + ni: nz + 2 * ni] = G.T
        KKT[:nz, nz + 2 * ni:] = A.T
        KKT[nz: nz + ni, nz: nz + ni] = np.diag(sigma_diag)
        KKT[nz: nz + ni, nz + ni: nz + 2 * ni] = np.eye(ni)
        KKT[nz + ni: nz + 2 * ni, :nz] = G
        KKT[nz + ni: nz + 2 * ni, nz: nz + ni] = np.eye(ni)
        KKT[nz + ni: nz + 2 * ni, nz + ni: nz + 2 * ni] = -delta * np.eye(ni)
        KKT[nz + 2 * ni:, :nz] = A
        KKT[nz + 2 * ni:, nz + 2 * ni:] = -delta * np.eye(ne)

        rhs_aff = np.concatenate([-rx, -(s * z) / s, -rs, -re])
        sol_aff = np.linalg.solve(KKT, rhs_aff)
        ds_aff = sol_aff[nz: nz + ni]
        dz_aff = sol_aff[nz + ni: nz + 2 * ni]

        alpha_aff_pri = _frac_to_boundary(s, ds_aff)
        alpha_aff_dual = _frac_to_boundary(z, dz_aff)

        mu_aff = float((s + alpha_aff_pri * ds_aff) @ (z + alpha_aff_dual * dz_aff)) / ni
        sigma = (mu_aff / mu) ** 3

        rc_corr = s * z + ds_aff * dz_aff - sigma * mu
        rhs_corr = np.concatenate(
            [np.zeros(nz), -rc_corr / s, np.zeros(ni), np.zeros(ne)]
        )
        sol_corr = np.linalg.solve(KKT, rhs_corr)

        sol = sol_aff + sol_corr
        dx = sol[:nz]
        ds = sol[nz: nz + ni]
        dz = sol[nz + ni: nz + 2 * ni]
        dy = sol[nz + 2 * ni:]

        alpha_pri = _frac_to_boundary(s, ds)
        alpha_dual = _frac_to_boundary(z, dz)

        x = x + alpha_pri * dx
        s = np.maximum(s + alpha_pri * ds, 1e-8)
        z = np.maximum(z + alpha_dual * dz, 1e-8)
        y = y + alpha_dual * dy

        residuals = np.array(
            [np.linalg.norm(rx), np.linalg.norm(rs), np.linalg.norm(re),
             float(s @ z) / ni]
        )
        if trace:
            history.append((x.copy(), s.copy(), z.copy(), y.copy()))

    if trace:
        return x, s, z, y, residuals, history
    return x, s, z, y, residuals


def _frac_to_boundary(v: np.ndarray, dv: np.ndarray) -> float:
    """alpha = max(min(1, 0.99 * min_i(dv<0 ? -v/dv : 1)), 1e-12).

    Parity: `sparse_pdipm_solver.py:459-467`.
    """
    cand = np.where(dv < 0, -v / np.where(dv < 0, dv, -1.0), 1.0)
    return float(max(min(1.0, 0.99 * cand.min()), 1e-12))
