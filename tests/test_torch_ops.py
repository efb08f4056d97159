"""pypmc_tpu_torch.ops against pypmc_tpu.ops: the deterministic functions in
float64 against the JAX XLA path, the plain kernel versions in float32
against the JAX Pallas kernels in interpret mode, and the chi-square sampler
in distribution.  Inputs are made with numpy and handed to both packages."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import pypmc_tpu.density.core as jcore
import pypmc_tpu.ops.pallas_kernels as pk
from pypmc_tpu.ops import linalg as jlinalg
from pypmc_tpu.ops import lse as jlse
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels, linalg, lse, random

torch.set_num_threads(1)

RTOL64, ATOL64 = 1e-10, 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spd(rng, K, D):
    a = rng.normal(0, 0.4, (K, D, D))
    return np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)


def mixture(rng, K, D, student_t, dead=False, dtype=np.float64):
    means = rng.normal(0, 2, (K, D))
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    jp, valid = jcore.make_mixture(cast(means), cast(spd(rng, K, D)), cast(w / w.sum()),
                                   cast(dofs))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


# ------------------------------------------------------------------ #
# float64 against the XLA path                                        #
# ------------------------------------------------------------------ #

def test_logsumexp_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 30, (257, 5))
    a[3] = -np.inf
    a[7, 2] = -np.inf
    w = rng.dirichlet(np.ones(5))
    ref = np.asarray(jlse.logsumexp(jnp.asarray(a), jnp.asarray(w), axis=-1))
    got = lse.logsumexp(torch.tensor(a), torch.tensor(w), axis=-1).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=ATOL64)
    got2 = lse.logsumexp2D(torch.tensor(a), torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got, got2)
    assert np.isneginf(got[3])


def test_regularize_and_tiny():
    x = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    out = lse.regularize(x)
    assert out[0] == lse.tiny(torch.float64) == jlse.tiny(jnp.float64)
    assert x[0] == 0.0   # input not mutated
    np.testing.assert_array_equal(out[1:].numpy(), [1.0, -2.0])


def test_chol_inv_det_matches_jax_and_masks_non_pd():
    rng = np.random.default_rng(1)
    m = spd(rng, 5, 6)
    m[1] = -m[1]                         # negative definite
    m[3, 0, 0] = np.nan                  # non-finite input
    ref = jlinalg.chol_inv_det(jnp.asarray(m))
    got = linalg.chol_inv_det(torch.tensor(m))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(valid, [True, False, True, False, True])
    for f in ("chol", "inv_chol", "inv"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(got.log_det.numpy()[valid], np.asarray(ref.log_det)[valid],
                               rtol=RTOL64, atol=ATOL64)
    assert np.isnan(got.chol.numpy()[~valid]).all()


def test_symmetrize_and_bilinear_sym():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(3, 4, 4))
    v = rng.normal(size=(3, 4))
    np.testing.assert_allclose(linalg.symmetrize(torch.tensor(m)).numpy(),
                               np.asarray(jlinalg.symmetrize(jnp.asarray(m))),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(
        linalg.bilinear_sym(torch.tensor(m), torch.tensor(v)).numpy(),
        np.asarray(jlinalg.bilinear_sym(jnp.asarray(m), jnp.asarray(v))),
        rtol=RTOL64, atol=ATOL64)


# ------------------------------------------------------------------ #
# chi-square sampler, in distribution                                  #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("df", [0.7, 3.5, 40.0])
def test_chi2_log_ks_against_scipy(df):
    draws = random.chisquare(123, torch.tensor(df, dtype=torch.float64), (20000,)).numpy()
    assert np.isfinite(draws).all() and (draws > 0).all()
    _, p = stats.kstest(draws, "chi2", args=(df,))
    assert p > 1e-3, p


def test_chi2_log_seeded_and_tiny_dof():
    a = random.chi2_log(5, torch.tensor(1e-5), (1000,))
    b = random.chi2_log(5, torch.tensor(1e-5), (1000,))
    c = random.chi2_log(6, torch.tensor(1e-5), (1000,))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()        # log space: no underflow to -inf
    scale = random.student_t_scale(7, torch.full((4000,), 8.0, dtype=torch.float64), (4000,))
    # E[dof / chi2(dof)] = dof / (dof - 2)
    np.testing.assert_allclose(float((scale ** 2).mean()), 8.0 / 6.0, rtol=0.05)


# ------------------------------------------------------------------ #
# the dispatch gate and the dense kernels' stated limits             #
# ------------------------------------------------------------------ #

def test_dispatch_gate():
    x = torch.zeros(3)
    assert kernels.use_kernel(x) is False
    assert kernels.use_kernel(x.double()) is False
    with pytest.raises(TypeError):
        kernels.use_kernel(torch.zeros(3, device="meta"))


def test_limits_are_stated_and_enforced():
    _build.check_limits("fused_is_pmc_step", 10, 10, 2)     # the flagship fits
    with pytest.raises(ValueError, match="limit"):
        _build.check_limits("fused_is_pmc_step", 64, 40, 2)
    with pytest.raises(ValueError, match="D <= 32"):
        _build.check_limits("fused_logq", 1, 33)
    assert _build.smem_bytes("fused_is_pmc_step", 10, 10, 2) < _build.SMEM_LIMIT


def test_package_imports_without_jax():
    code = "import pypmc_tpu_torch, sys; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# ------------------------------------------------------------------ #
# plain kernel versions against the Pallas kernels (interpret mode)   #
# ------------------------------------------------------------------ #

@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)
    monkeypatch.setattr(jcore, "use_pallas", lambda *a, **k: True)


@pytest.mark.parametrize("student_t,dead", [(True, False), (False, True)])
def test_plain_logq_matches_pallas_interpret(interpret, student_t, dead):
    rng = np.random.default_rng(3)
    jp, tp = mixture(rng, 3, 5, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (5, 1500)).astype(np.float32)
    a2, b2, ln, w, dof, center = jcore._pallas_operands(jp, "inv_chol")
    ref = np.asarray(pk.fused_logq(jnp.asarray(xT), a2, b2, ln, w, dof, center, dim=5))
    got = kernels.fused_logq(torch.tensor(xT), core._kernel_operands(tp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("student_t,dead", [(True, True), (False, False)])
def test_plain_pmc_stats_matches_pallas_interpret(interpret, student_t, dead):
    """Statistics are compared per particle (divided by N): the sums of the
    two float32 paths run in different orders."""
    import jax

    rng = np.random.default_rng(4)
    D, N = 4, 1999
    jp, tp = mixture(rng, 3, D, student_t, dead, dtype=np.float32)
    xT = rng.normal(0, 2, (D, N)).astype(np.float32)
    w = rng.exponential(1.0, N).astype(np.float32)
    a2, b2, ln, wk, dof, _ = jcore._pallas_operands(jp, "inv_chol")
    psi = (jax.scipy.special.digamma(0.5 * (D + jp.dof)).reshape(3, 1)
           if student_t else None)
    ref = pk.fused_pmc_stats(jnp.asarray(xT), jnp.asarray(w), a2, b2, ln, wk, dof, psi,
                             dim=D, dof_stats=student_t)
    got = kernels.fused_pmc_stats(torch.tensor(xT), torch.tensor(w),
                                  core._kernel_operands(tp), student_t)
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        np.testing.assert_allclose(got[key].numpy() / N, np.asarray(ref[key]) / N,
                                   rtol=2e-3, atol=2e-3, err_msg=key)
