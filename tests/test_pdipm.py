"""Solver tests: structured QP operators and PDIPM vs the golden reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench_common import make_converged_qp
from biped_pympc_tpu.ops import pdipm, qp as qps, reference_pdipm

T = 10


def _make_qp(seed=0, dtype=jnp.float64, contact=None, vx=0.3):
    return make_converged_qp(dtype, seed=seed, contact=contact, vx=vx,
                             horizon=T)


def test_structured_operators_match_dense():
    qp = _make_qp()
    H, f, A, b, G, d = qps.dense_matrices(qp)
    rng = np.random.default_rng(1)
    zz = rng.standard_normal(qp.nz)
    lam = rng.standard_normal(qp.n_ineq)
    yy = rng.standard_normal(qp.n_eq)
    np.testing.assert_allclose(qps.g_matvec(qp, jnp.asarray(zz)), G @ zz, atol=1e-12)
    np.testing.assert_allclose(qps.gT_matvec(qp, jnp.asarray(lam)), G.T @ lam, atol=1e-12)
    np.testing.assert_allclose(qps.a_matvec(qp, jnp.asarray(zz)), A @ zz, atol=1e-12)
    np.testing.assert_allclose(qps.aT_matvec(qp, jnp.asarray(yy)), A.T @ yy, atol=1e-12)
    np.testing.assert_allclose(qps.b_vec(qp), b, atol=1e-12)
    np.testing.assert_allclose(qps.d_vec(qp), d, atol=1e-12)
    np.testing.assert_allclose(np.diag(H), qps.h_diag(qp), atol=1e-12)
    np.testing.assert_allclose(f, qp.f, atol=1e-12)


def test_qp_dims_match_reference():
    """240 vars, 140 eq, 160 ineq at horizon 10 (`generate_solver_function.py:81-85`)."""
    qp = _make_qp()
    assert (qp.nz, qp.n_eq, qp.n_ineq) == (240, 140, 160)


@pytest.mark.parametrize("backend", ["dense", "tridiag", "ric", "ric_aug"])
def test_pdipm_matches_golden(backend):
    qp = _make_qp()
    H, f, A, b, G, d = qps.dense_matrices(qp)
    gx, gs, gz, gy, gres = reference_pdipm.solve(
        H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]),
        iterations=20,
    )
    res = jax.jit(
        lambda q: pdipm.solve(q, pdipm.PdipmOptions(backend=backend))
    )(qp)
    # Two-tier bound: the bulk of entries must stay tight (median < 3e-7,
    # measured medians are <= 5.3e-8 across all four backends — the real
    # regression tripwire); a worst-entry allowance of 1e-5 covers the
    # weakly-determined tail where roundoff-level input differences (e.g.
    # the closed-form 3x3 inertia inverse `srbd._inv3` vs LAPACK's LU) are
    # amplified by 20 near-complementarity Newton iterations (same class as
    # the reassociation noise documented in the BCR test).
    for got, want in [(res.x, gx), (res.s, gs), (res.z, gz), (res.y, gy)]:
        err = np.abs(np.asarray(got) - want)
        assert np.median(err) < 3e-7, (backend, np.sort(err)[-5:])
        assert err.max() < 1e-5, (backend, np.sort(err)[-5:])
    # residual norms live at ~1e-11; compare with an absolute floor
    np.testing.assert_allclose(
        np.asarray(res.residuals), gres, rtol=1e-6, atol=1e-13
    )


def test_pdipm_swing_contact_pattern_matches_golden():
    """Contact gating: swinging feet must get ~zero force, still match golden."""
    contact = np.ones((T, 2))
    contact[2:6, 0] = 0.0
    contact[6:9, 1] = 0.0
    qp = _make_qp(contact=contact)
    H, f, A, b, G, d = qps.dense_matrices(qp)
    gx, *_ = reference_pdipm.solve(
        H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]),
        iterations=20,
    )
    res = pdipm.solve(qp, pdipm.PdipmOptions(backend="tridiag"))
    np.testing.assert_allclose(np.asarray(res.x), gx, atol=1e-7)
    # stage 3 (inside the left-swing window): left fz ~ 0 (interior-point
    # iterates keep micro-Newton slack after 20 fixed iterations)
    u3 = np.asarray(res.x)[12 * T + 12 * 3: 12 * T + 12 * 4]
    assert abs(u3[2]) < 1e-4


def test_pdipm_batched_vmap_consistency():
    """vmapped batch solve == per-env solves."""
    qs = [_make_qp(seed=s, vx=0.1 * s) for s in range(4)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *qs)
    opts = pdipm.PdipmOptions(backend="tridiag")
    bres = jax.jit(jax.vmap(lambda q: pdipm.solve(q, opts)))(batched)
    for i, q in enumerate(qs):
        single = pdipm.solve(q, opts)
        # batched LU kernels reassociate reductions; bit-exactness is not
        # expected, agreement far beyond control tolerance is
        np.testing.assert_allclose(
            np.asarray(bres.x[i]), np.asarray(single.x), atol=1e-6
        )


@pytest.mark.parametrize("backend", ["tridiag_aug"])
def test_pdipm_aug_backend_matches_golden_f64(backend):
    """The augmented (54-wide) stage formulation is exact block elimination
    of the same system — f64 iterates must match the golden reference."""
    qp = _make_qp()
    H, f, A, b, G, d = qps.dense_matrices(qp)
    gx, *_ = reference_pdipm.solve(
        H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]),
        iterations=20,
    )
    res = pdipm.solve(qp, pdipm.PdipmOptions(backend=backend))
    np.testing.assert_allclose(np.asarray(res.x), gx, atol=1e-6)


def test_pdipm_float32_grf_accuracy():
    """f32 path (augmented backend + 1 refinement) tracks the f64 golden.

    The augmented stage formulation keeps the complementarity scaling on
    diagonal entries instead of condensing G^T W^-1 G (which squares the
    conditioning); measured agreement on converged problems is <=1e-2 N and
    the per-iterate KKT quality matches f64 even on problems that are not
    converged at the 20-iteration cap (where the f64 iterate itself is tens
    of N away from the true optimum)."""
    qp64 = _make_qp()
    qp32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), qp64)
    g = pdipm.solve(qp64, pdipm.PdipmOptions(backend="tridiag"))
    opts32 = pdipm.PdipmOptions(backend="tridiag_aug", refine_steps=1)
    r32 = pdipm.solve(qp32, opts32)
    u0_64 = np.asarray(g.x)[12 * T: 12 * T + 12]
    u0_32 = np.asarray(r32.x)[12 * T: 12 * T + 12]
    np.testing.assert_allclose(u0_32, u0_64, atol=0.05)


def test_mx_equality_enforced():
    qp = _make_qp()
    res = pdipm.solve(qp, pdipm.PdipmOptions(backend="tridiag"))
    u = np.asarray(res.x)[12 * T:].reshape(T, 12)
    np.testing.assert_allclose(u[:, 6], 0.0, atol=1e-6)
    np.testing.assert_allclose(u[:, 9], 0.0, atol=1e-6)


def test_friction_cone_satisfied():
    qp = _make_qp(vx=0.5)
    res = pdipm.solve(qp, pdipm.PdipmOptions(backend="tridiag"))
    g_viol = np.asarray(qps.g_matvec(qp, res.x)) - np.asarray(qps.d_vec(qp))
    assert g_viol.max() < 1e-5


@pytest.mark.slow
def test_combined_corrector_matches_delta_form():
    """corrector_form="combined" equals the reference "delta" form.

    The reference solves the corrector increment with zero KKT-residual rhs
    and ADDS it to the (refined) affine direction
    (`sparse_pdipm_solver.py:476-486`); because iterative refinement is a
    linear map, one refined solve of the summed rhs is algebraically
    identical at one fewer refined solve per iteration. Pinned here at f64
    by golden parity."""
    qp = _make_qp()
    for backend in ("tridiag", "tridiag_aug"):
        for refine in (0, 1):
            rd = pdipm.solve(qp, pdipm.PdipmOptions(
                backend=backend, refine_steps=refine,
                corrector_form="delta"))
            rc = pdipm.solve(qp, pdipm.PdipmOptions(
                backend=backend, refine_steps=refine,
                corrector_form="combined"))
            np.testing.assert_allclose(
                np.asarray(rc.x), np.asarray(rd.x), atol=2e-5)


@pytest.mark.slow
def test_sum_refine_corrector_matches_delta_form():
    """corrector_form="sum_refine" equals the reference "delta" form at f64.

    Unrefined affine + unrefined corrector, then refinement of the summed
    direction against the full 4-row KKT residual — linear-algebraically
    the same direction. (Rejected as the f32 default: the unrefined affine
    predictor degrades sigma/centering on near-degenerate problems.)"""
    qp = _make_qp()
    for backend in ("tridiag", "tridiag_aug"):
        for refine in (0, 1):
            rd = pdipm.solve(qp, pdipm.PdipmOptions(
                backend=backend, refine_steps=refine,
                corrector_form="delta"))
            rc = pdipm.solve(qp, pdipm.PdipmOptions(
                backend=backend, refine_steps=refine,
                corrector_form="sum_refine"))
            np.testing.assert_allclose(
                np.asarray(rc.x), np.asarray(rd.x), atol=2e-5)


@pytest.mark.slow
def test_solve_adaptive_batch_matches_fixed():
    """Pure-JAX adaptive chunking: tol=0 == the fixed-iteration solve, and
    the early stop triggers with a loose tolerance."""
    qs = [_make_qp(seed=s, vx=0.1 * s) for s in range(4)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *qs)
    opts = pdipm.PdipmOptions(backend="tridiag_aug")
    fixed = jax.vmap(lambda q: pdipm.solve(q, opts).x)(batch)
    chunked = pdipm.solve_adaptive_batch(batch, opts, tol=0.0)
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(fixed),
                               atol=1e-9)
    one = jax.vmap(
        lambda q: pdipm.solve(q, opts._replace(iterations=5)).x)(batch)
    loose = pdipm.solve_adaptive_batch(batch, opts, tol=1e12)
    np.testing.assert_allclose(np.asarray(loose.x), np.asarray(one),
                               atol=1e-9)
    # Non-divisible cap runs EXACTLY iterations steps (12 = 2x5 + rem 2),
    # never a rounded-up 15.
    o12 = opts._replace(iterations=12, iterations_per_launch=5)
    fixed12 = jax.vmap(lambda q: pdipm.solve(q, o12).x)(batch)
    chunked12 = pdipm.solve_adaptive_batch(batch, o12, tol=0.0)
    np.testing.assert_allclose(np.asarray(chunked12.x), np.asarray(fixed12),
                               atol=1e-9)


def test_foot_split_exactness():
    """foot_split blockwise stage inverses are EXACT: the stage blocks are
    block-diagonal by foot (zero off-block entries), so eliminating the
    dense matrix has no fill-in and the split path reproduces the dense
    path bitwise at f64 — for both "ric" and "ric_aug"."""
    qp = _make_qp(seed=3, dtype=jnp.float64, vx=0.2)
    for backend in ("ric", "ric_aug"):
        base = pdipm.solve(
            qp, pdipm.PdipmOptions(backend=backend, iterations=20))
        split = pdipm.solve(
            qp, pdipm.PdipmOptions(backend=backend, iterations=20,
                                   foot_split=True))
        np.testing.assert_array_equal(np.asarray(base.x), np.asarray(split.x))
        np.testing.assert_array_equal(np.asarray(base.z), np.asarray(split.z))
        np.testing.assert_array_equal(np.asarray(base.y), np.asarray(split.y))


def test_jacobi_kkt_scale_is_exact_preconditioning():
    """kkt_scale="jacobi" must change NOTHING algebraically: at f64 the
    scaled factorization reproduces the unscaled iterates to roundoff
    (K^-1 = D (D K D)^-1 D exactly)."""
    qp = _make_qp(seed=5, contact=np.concatenate(
        [np.tile([[1.0, 0.0]], (5, 1)), np.tile([[0.0, 1.0]], (5, 1))]))
    # Tolerance note: the identity is exact PER FACTORIZATION; over 20
    # Newton steps the per-solve f64 roundoff (~1e-16 x the condensed
    # blocks' 1e8 scale on this contact-chattering problem) is amplified
    # by the iteration dynamics — measured drift <= 4e-6 (condensed),
    # <= 1e-11 (augmented, walking problems).
    for backend, split in [("ric", False), ("ric_aug", False),
                           ("ric_aug", True)]:
        base = pdipm.PdipmOptions(backend=backend, foot_split=split)
        r0 = pdipm.solve(qp, base)
        r1 = pdipm.solve(qp, base._replace(kkt_scale="jacobi"))
        for f0, f1 in zip(r0, r1):
            np.testing.assert_allclose(
                np.asarray(f0), np.asarray(f1), rtol=1e-6, atol=1e-4,
                err_msg=f"{backend} split={split}")


def test_ric_aug_core_solve_matches_ric_aug():
    """The scaled Riccati-core factorization is the SAME block elimination
    as ric_aug (per-solve parity ~1e-12 at f64); it is REJECTED as a
    product backend because its u-first Schur complement S = -(W + V V^T)
    is rank-deficient on swing feet (all 8 inequality rows active with a
    rank-4 per-foot G) — explicit S^-1 loses the solution there, measured
    as NaN at f32 and ~0.5 end-to-end drift at f64."""
    from biped_pympc_tpu.ops.pdipm import (
        PdipmState, _factor_ric_aug, _solve_ric_aug,
        _factor_ric_aug_core, _solve_ric_aug_core, N_INEQ_PER_STAGE)

    qp = _make_qp(seed=3)
    opts = pdipm.PdipmOptions(backend="ric_aug")
    res = pdipm.solve(qp, opts._replace(iterations=15))
    sigma_d = res.z / res.s + opts.delta
    w_diag = (1.0 / sigma_d + opts.delta).reshape(T, N_INEQ_PER_STAGE)

    fa = _factor_ric_aug(qp, w_diag, opts)
    fc = _factor_ric_aug_core(qp, w_diag, opts)
    rng = np.random.default_rng(0)
    r1 = jnp.asarray(rng.standard_normal(qp.nz))
    rz = jnp.asarray(rng.standard_normal(qp.n_ineq))
    r4 = jnp.asarray(rng.standard_normal(qp.n_eq))
    xa = _solve_ric_aug(qp, fa, r1, rz, r4)
    xc = _solve_ric_aug_core(qp, fc, r1, rz, r4)
    for a, c in zip(xa, xc):
        scale = np.abs(np.asarray(a)).max()
        np.testing.assert_allclose(
            np.asarray(c), np.asarray(a), rtol=0, atol=1e-8 * max(scale, 1.0))


def test_kkt_error_criterion():
    """kkt_error must be ~0 at a converged solution and large at a
    perturbed one (the round-4 hybrid flag criterion)."""
    qp = _make_qp()
    # At the reference's fixed 20-iteration cap the iterate is NOT fully
    # converged (mu ~ 2e-3, stationarity ~ 0.5 in cost-gradient units);
    # more iterations drive the criterion down — that monotonicity plus
    # separation from a corrupted solution is what the flag needs.
    res20 = pdipm.solve(qp, pdipm.PdipmOptions(backend="tridiag_aug"))
    e20 = np.asarray(pdipm.kkt_error(qp, res20))
    assert e20.shape == (4,)
    res40 = pdipm.solve(
        qp, pdipm.PdipmOptions(backend="tridiag_aug", iterations=40))
    e40 = np.asarray(pdipm.kkt_error(qp, res40))
    assert float(e40.max()) < float(e20.max())
    assert float(e40[:3].max()) < 1e-4, e40
    bad = res20._replace(x=res20.x + 1.0)
    eb = np.asarray(pdipm.kkt_error(qp, bad))
    assert float(eb[:3].max()) > 10.0 * float(e20[:3].max()), (eb, e20)


def test_unknown_backend_rejected():
    """The solver layer validates opts.backend itself (after narrowing the
    valid set, the dispatch's trailing else
    would otherwise silently run tridiag for a stale string like the
    removed "bcr" — mislabeling benchmarks)."""
    qp = _make_qp()
    with pytest.raises(ValueError, match="unknown pdipm backend"):
        pdipm.solve(qp, pdipm.PdipmOptions(backend="bcr"))


def test_df_residual_accuracy():
    """ops/df.py compensated residual: on a cancellation-dominated
    refinement residual (r ~ K d + tiny), the double-float residual must
    track the f64 ground truth orders of magnitude tighter than the plain
    f32 residual. Inputs are passed as JIT ARGUMENTS — closing over them
    as constants lets XLA's constant folder algebraically simplify the
    error-free transformations away (measured: rel err 8e-3 constant-
    folded vs 4e-8 traced; see ops/df.py docstring)."""
    from biped_pympc_tpu.ops import df as dfm

    qp64 = _make_qp(dtype=jnp.float64)
    qp32 = jax.tree.map(lambda a: a.astype(jnp.float32), qp64)
    T_ = qp32.horizon
    rng = np.random.default_rng(3)
    beta = delta = 1e-8
    # Realistic late-iteration scales: wide-spread W diagonal, O(30)
    # direction entries.
    w32 = jnp.asarray(10.0 ** rng.uniform(-6, 6, 16 * T_), jnp.float32)
    dx32 = jnp.asarray(rng.standard_normal(24 * T_) * 30, jnp.float32)
    dz32 = jnp.asarray(rng.standard_normal(16 * T_) * 30, jnp.float32)
    dy32 = jnp.asarray(rng.standard_normal(14 * T_) * 30, jnp.float32)
    f64a = lambda a: np.asarray(a, np.float64)

    def matvec(qp, hd, w_diag, dx, dz, dy):
        m1 = (hd + beta) * dx + qps.gT_matvec(qp, dz) + qps.aT_matvec(qp, dy)
        mz = qps.g_matvec(qp, dx) - w_diag * dz
        m4 = qps.a_matvec(qp, dx) - delta * dy
        return m1, mz, m4

    # f64 ground truth over the f32-stored system data.
    qp64d = jax.tree.map(lambda a: jnp.asarray(f64a(a), jnp.float64), qp32)
    m64 = matvec(
        qp64d, jnp.asarray(f64a(qps.h_diag(qp32))), jnp.asarray(f64a(w32)),
        jnp.asarray(f64a(dx32)), jnp.asarray(f64a(dz32)),
        jnp.asarray(f64a(dy32)))
    # rhs = K d + small true residual (the cancellation scenario).
    r32 = [jnp.asarray(np.asarray(m) + rng.standard_normal(m.shape[0]) * 1e-4,
                       jnp.float32) for m in m64]
    e_true = [f64a(r) - np.asarray(m) for r, m in zip(r32, m64)]

    hd32 = qps.h_diag(qp32)
    m32 = jax.jit(matvec)(qp32, hd32, w32, dx32, dz32, dy32)
    e_f32 = [np.asarray(r - m) for r, m in zip(r32, m32)]

    jf = jax.jit(lambda qp, hd, w, dx, dz, dy, r1, rz, r4:
                 dfm.residual_aug(qp, hd, w, beta, delta, dx, dz, dy,
                                  r1, rz, r4))
    e_df = [np.asarray(e) for e in jf(qp32, hd32, w32, dx32, dz32, dy32, *r32)]

    for name, ef32, edf, et in zip(("e1", "ez", "e4"), e_f32, e_df, e_true):
        scale = np.abs(et).max() + 1e-30
        err_f32 = np.abs(ef32 - et).max() / scale
        err_df = np.abs(edf - et).max() / scale
        # f32 residual loses most digits to cancellation; df is
        # ~f32-eps-accurate relative to the residual scale.
        assert err_df < 1e-6, (name, err_df)
        assert err_df < err_f32 / 100, (name, err_f32, err_df)


def test_df_residual_rejected_on_condensed_backends():
    """refine_residual='df' is aug-only; the condensed backends must
    reject it loudly instead of silently running the f32 residual."""
    qp = _make_qp(dtype=jnp.float32)
    for backend in ("ric", "tridiag", "dense"):
        with pytest.raises(ValueError, match="aug"):
            pdipm.solve(qp, pdipm.PdipmOptions(
                backend=backend, refine_steps=1, refine_residual="df"))
    # sum_refine refines in its own outer full-KKT loop (plain f32
    # residuals) — df would be silently ignored there; rejected instead.
    with pytest.raises(ValueError, match="sum_refine"):
        pdipm.solve(qp, pdipm.PdipmOptions(
            backend="ric_aug", refine_steps=1, refine_residual="df",
            corrector_form="sum_refine"))
