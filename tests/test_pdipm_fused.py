"""Fused native solver (`ops/pdipm_fused.py`): the CPU target drives the
same FFI wrapper, packing, padding and sharding as the CUDA target; the
`gpu` tests run the CUDA target on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench_common import make_converged_qp, make_qp_batch
from biped_pympc_tpu.ops import pdipm, pdipm_fused

T = 10
OPTS = pdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1)


def _u0(res):
    return np.asarray(res.x)[:, 12 * T: 12 * T + 12]


@pytest.fixture(scope="module")
def stress():
    return make_qp_batch(8)


@pytest.fixture(scope="module")
def fused_stress(stress):
    return jax.jit(lambda q: pdipm_fused.solve(q, OPTS))(stress)


def test_pack_is_batch_last(stress):
    """Column b of the packed input is env b's QP data, constants first."""
    packed = np.asarray(pdipm_fused.pack(stress))
    assert packed.shape == (pdipm_fused.input_len(T), 8)
    b = 5
    env = jax.tree.map(lambda a: np.asarray(a[b]).reshape(-1), stress)
    want = np.concatenate([env.q_diag, env.r_diag, env.dyn.A, env.dyn.B,
                           env.dyn.c, env.b0, env.g_u, env.f, env.d])
    np.testing.assert_array_equal(packed[:, b], want)


def test_fused_matches_plain_ric_aug(stress, fused_stress):
    """Same algorithm as the vmapped pure-JAX ric_aug: GRFs agree to f32
    rounding amplified by 20 Newton steps on the stress problems."""
    plain = jax.jit(jax.vmap(lambda q: pdipm.solve(q, OPTS)))(stress)
    for field in ("x", "s", "z", "y", "residuals"):
        got = np.asarray(getattr(fused_stress, field))
        assert got.shape == getattr(plain, field).shape, field
        assert np.isfinite(got).all(), field
    np.testing.assert_allclose(_u0(fused_stress), _u0(plain), atol=0.5)
    np.testing.assert_allclose(np.asarray(fused_stress.y),
                               np.asarray(plain.y), atol=0.05)


def test_fused_matches_golden_converged():
    """The converged reference problem within the f32 bound of
    `test_pdipm_float32_grf_accuracy` (0.05 N)."""
    from ab_accuracy import golden

    qp = make_converged_qp(jnp.float32)
    gx = golden(jax.tree.map(lambda a: np.asarray(a, np.float64), qp))[0]
    res = pdipm_fused.solve(jax.tree.map(lambda a: a[None], qp), OPTS)
    np.testing.assert_allclose(_u0(res)[0], gx[12 * T: 12 * T + 12],
                               atol=0.05)


@pytest.mark.parametrize("batch", [1, 5, 33])
def test_odd_batches_are_padded(stress, fused_stress, batch):
    """Batches off the warp multiple are padded with copies of the last
    env and trimmed; every env's solve is independent, so each result
    equals that env's result inside the full batch bit for bit."""
    idx = np.arange(batch) % 8
    qp = jax.tree.map(lambda a: a[idx], stress)
    res = pdipm_fused.solve(qp, OPTS)
    assert res.x.shape == (batch, 24 * T)
    np.testing.assert_array_equal(np.asarray(res.x),
                                  np.asarray(fused_stress.x)[idx])


@pytest.mark.parametrize("change", [
    {"backend": "tridiag_aug"}, {"foot_split": False},
    {"refine_steps": 0}, {"corrector_form": "combined"},
    {"refine_residual": "df"}, {"kkt_scale": "jacobi"},
])
def test_unsupported_options_rejected(stress, change):
    with pytest.raises(ValueError, match="fused solver runs only"):
        pdipm_fused.solve(stress, OPTS._replace(**change))


def test_float64_rejected(stress):
    qp64 = jax.tree.map(lambda a: a.astype(jnp.float64), stress)
    with pytest.raises(ValueError, match="float32 only"):
        pdipm_fused.solve(qp64, OPTS)


def test_adaptive_iterations_rejected():
    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore

    core = BipedControllerCore(
        ControllerConf(), MPCConf(solver="fused_ric_aug", adaptive_tol=1e-2,
                                  verbose=False), gait_id=1)
    with pytest.raises(ValueError, match="adaptive_tol"):
        core.run_mpc(core.init_state(2))


def test_fused_shard_map_matches_single_device():
    """`mesh.controller_step` runs the fused solver per device on its shard
    of the env batch (8 virtual devices) and equals the unsharded step."""
    from biped_pympc_tpu import ControllerConf, MPCConf
    from biped_pympc_tpu.control.controller import BipedControllerCore
    from biped_pympc_tpu.parallel import mesh as pmesh

    core = BipedControllerCore(
        ControllerConf(),
        MPCConf(solver="fused_ric_aug", newton_iterations=4, verbose=False),
        gait_id=2)
    B = 16
    obs = np.zeros((B, 43), np.float32)
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45], np.float32)
    obs[:, 13:18] = obs[:, 18:23] = q0
    obs = jnp.asarray(obs)
    twist = jnp.zeros((B, 3), jnp.float32).at[:, 0].set(0.2)
    height = jnp.full((B,), 0.55, jnp.float32)
    _, tau_single, out_single = core.control_step(
        core.init_state(B), obs, twist, height)

    mesh = pmesh.make_mesh(jax.devices()[:8])
    step = pmesh.controller_step(core, mesh)
    _, tau_sm, out_sm = step(core.init_state(B), obs, twist, height)
    assert np.isfinite(np.asarray(tau_sm)).all()
    np.testing.assert_allclose(np.asarray(tau_sm), np.asarray(tau_single),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_sm.grf_world),
                               np.asarray(out_single.grf_world), atol=1e-4)


def test_worst_disagreement_report():
    """The accuracy phase's full-batch comparison (`chip_smoke.py` runs it
    at b4096): the k most-disagreeing envs go to the golden, and the fused
    solver's envs are independent of the batch they are solved in."""
    from ab_accuracy import worst_disagreement

    rec = worst_disagreement(batch=24, k=2, converged_iterations=30)
    assert len(rec["env_index"]) == 2
    assert rec["disagreement"]["max_N"] >= rec["disagreement"]["median_N"]
    for name in ("ric_aug", "fused_ric_aug"):
        r = rec["solvers"][name]
        assert r["nonfinite_envs"] == 0
        assert np.isfinite(r["vs_golden20"]["max_N"])
        assert np.isfinite(r["vs_optimum"]["max_N"])
    assert rec["solvers"]["fused_ric_aug"]["rebatched_move_N"] == 0.0


def test_library_build_is_cached():
    """The library is named by a hash of its sources and built once."""
    path = pdipm_fused.build_library("cpu")
    assert pdipm_fused.build_library("cpu") == path
    assert "libpdipm_fused_cpu-" in path


@pytest.mark.gpu
def test_cuda_solver_accuracy_on_card(gpu):
    """Both f32 solver ends against the golden on the card, as the
    accuracy phase of `chip_smoke.py` runs them."""
    from ab_accuracy import CONVERGED_BOUND_N, f32_accuracy

    recs = f32_accuracy(("ric_aug", "fused_ric_aug"), randomized_batch=256)
    assert all(r["nonfinite_envs"] == 0 for r in recs), recs
    assert all(r["max_N"] <= CONVERGED_BOUND_N for r in recs
               if r["set"] == "converged"), recs


@pytest.mark.gpu
def test_f64_plain_solver_on_card(gpu):
    from ab_accuracy import F64_MAX_BOUND, F64_MEDIAN_BOUND, f64_plain_vs_golden

    rec = f64_plain_vs_golden()
    assert rec["median_abs"] < F64_MEDIAN_BOUND, rec
    assert rec["max_abs"] < F64_MAX_BOUND, rec
