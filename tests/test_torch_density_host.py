"""The host density classes of pypmc_tpu_torch.density (Gauss, StudentT,
MixtureDensity and their local variants) against those of pypmc_tpu.density.

Evaluations agree in float64 to RTOL64/ATOL64.  With a numpy generator
both packages draw on the host with the reference's semantics, so one seed
gives identical samples; with an int seed the port draws through torch and
the JAX package through jax.random, so those draws are held to the
distribution's moments instead (6 Monte Carlo sigma)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density as jd
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
import pypmc_tpu_torch.density as td

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield

RTOL64, ATOL64 = 1e-10, 1e-12
MU = np.array([0.5, -1.0, 2.0])
SIGMA = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 0.5]])


def points(n=200, seed=0):
    return np.random.default_rng(seed).normal(0, 2, (n, 3))


def test_chol_inv_det_host_semantics():
    for t, j in zip(td.gauss.chol_inv_det_host(SIGMA), jd.gauss.chol_inv_det_host(SIGMA)):
        np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError):
        td.gauss.chol_inv_det_host(np.array([[np.nan, 0.0], [0.0, 1.0]]))
    with pytest.raises(np.linalg.LinAlgError):
        td.gauss.chol_inv_det_host(np.array([[1.0, 0.5], [0.0, 1.0]]))
    with pytest.raises(np.linalg.LinAlgError):
        td.gauss.chol_inv_det_host(-np.eye(2))


@pytest.mark.parametrize("student_t", [False, True])
def test_component_evaluate_matches_jax(student_t):
    args = (MU, SIGMA, 4.5) if student_t else (MU, SIGMA)
    t = (td.StudentT if student_t else td.Gauss)(*args)
    j = (jd.StudentT if student_t else jd.Gauss)(*args)
    x = points()
    np.testing.assert_allclose(t.multi_evaluate(x), j.multi_evaluate(x), rtol=RTOL64, atol=ATOL64)
    out = np.empty(len(x))
    t.multi_evaluate(x, out)
    np.testing.assert_allclose(out, j.multi_evaluate(x), rtol=RTOL64, atol=ATOL64)
    assert np.isclose(t.evaluate(x[0]), j.evaluate(x[0]), rtol=RTOL64, atol=ATOL64)
    local = td.LocalStudentT(SIGMA, 4.5) if student_t else td.LocalGauss(SIGMA)
    jlocal = jd.LocalStudentT(SIGMA, 4.5) if student_t else jd.LocalGauss(SIGMA)
    assert np.isclose(local.evaluate(x[0], x[1]), jlocal.evaluate(x[0], x[1]),
                      rtol=RTOL64, atol=ATOL64)
    assert local.symmetric


@pytest.mark.parametrize("student_t", [False, True])
def test_component_numpy_draws_match_jax(student_t):
    """A numpy generator draws on the host in both packages: one seed, the
    same samples."""
    args = (MU, SIGMA, 4.5) if student_t else (MU, SIGMA)
    t = (td.StudentT if student_t else td.Gauss)(*args)
    j = (jd.StudentT if student_t else jd.Gauss)(*args)
    np.testing.assert_allclose(t.propose(50, np.random.RandomState(3)),
                               j.propose(50, np.random.RandomState(3)), rtol=RTOL64)
    local = td.LocalStudentT(SIGMA, 4.5) if student_t else td.LocalGauss(SIGMA)
    jlocal = jd.LocalStudentT(SIGMA, 4.5) if student_t else jd.LocalGauss(SIGMA)
    np.testing.assert_allclose(local.propose(MU, np.random.RandomState(4)),
                               jlocal.propose(MU, np.random.RandomState(4)), rtol=RTOL64)


@pytest.mark.parametrize("student_t", [False, True])
def test_component_torch_draws_in_distribution(student_t):
    dof = 7.0
    comp = td.StudentT(MU, SIGMA, dof) if student_t else td.Gauss(MU, SIGMA)
    n = 40000
    x = comp.propose(n, rng=11)
    assert x.shape == (n, 3) and np.isfinite(x).all()
    cov = SIGMA * (dof / (dof - 2) if student_t else 1.0)
    se = np.sqrt(np.diag(cov) / n)
    assert np.all(np.abs(x.mean(0) - MU) < 6 * se)
    np.testing.assert_allclose(np.cov(x.T), cov, rtol=0.1, atol=0.05)
    assert not np.array_equal(comp.propose(10, rng=11), comp.propose(10, rng=12))
    np.testing.assert_array_equal(comp.propose(10, rng=11), comp.propose(10, rng=11))


@pytest.mark.parametrize("student_t", [False, True])
def test_component_update_rolls_back(student_t):
    """A failed update leaves the old state: an invalid covariance raises
    LinAlgError, a mean of another dimension ValueError."""
    comp = td.StudentT(MU, SIGMA, 4.5) if student_t else td.Gauss(MU, SIGMA)
    extra = (4.5,) if student_t else ()
    before = comp.evaluate(MU + 0.3)
    with pytest.raises(np.linalg.LinAlgError):
        comp.update(MU, -SIGMA, *extra)
    with pytest.raises(ValueError):
        comp.update(np.zeros(2), SIGMA, *extra)
    assert comp.evaluate(MU + 0.3) == before
    np.testing.assert_array_equal(comp.sigma, SIGMA)
    local = td.LocalGauss(SIGMA)
    with pytest.raises(np.linalg.LinAlgError):
        local.update(-SIGMA)
    np.testing.assert_array_equal(local.sigma, SIGMA)


def mixtures(student_t, weights=(1.0, 3.0, 0.5)):
    rng = np.random.default_rng(9)
    means = rng.normal(0, 2, (3, 3))
    a = rng.normal(0, 0.4, (3, 3, 3))
    covs = np.eye(3)[None] + np.einsum("kij,klj->kil", a, a)
    if student_t:
        dofs = [3.0, 5.0, 9.0]
        return (td.create_t_mixture(means, covs, dofs, weights),
                jd.create_t_mixture(means, covs, dofs, weights))
    return (td.create_gaussian_mixture(means, covs, weights),
            jd.create_gaussian_mixture(means, covs, weights))


@pytest.mark.parametrize("student_t", [False, True])
def test_mixture_stacked_params_and_evaluate_match_jax(student_t):
    t, j = mixtures(student_t)
    assert t.kind == j.kind
    for f, v in core.params_to_numpy(t.stacked_params()).items():
        ref = getattr(j.stacked_params(jnp.float64), f)
        if v is None:
            assert ref is None
        else:
            np.testing.assert_allclose(v, np.asarray(ref), rtol=RTOL64, atol=ATOL64, err_msg=f)
    x = points()
    ind_t, ind_j = np.empty((len(x), 3)), np.empty((len(x), 3))
    np.testing.assert_allclose(t.multi_evaluate(x, individual=ind_t),
                               j.multi_evaluate(x, individual=ind_j), rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(ind_t, ind_j, rtol=RTOL64, atol=ATOL64)
    assert np.isclose(t.evaluate(x[0]), j.evaluate(x[0]), rtol=RTOL64, atol=ATOL64)


def test_mixture_multi_evaluate_on_unnormalized_weights():
    """multi_evaluate uses the weights as stored, as evaluate does."""
    t, j = mixtures(False)
    t.weights = t.weights * 3.0
    j.weights = j.weights * 3.0
    assert not t.normalized()
    x = points()
    res = t.multi_evaluate(x)
    np.testing.assert_allclose(res, j.multi_evaluate(x), rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(res[:3], [t.evaluate(p) for p in x[:3]], rtol=RTOL64)
    t.normalize()
    assert t.normalized()


def test_mixture_prune_set_params_and_from_params():
    t, j = mixtures(True, weights=(1.0, 0.0, 2.0))
    removed, jremoved = t.prune(), j.prune()
    assert [(i, w) for i, _, w in removed] == [(i, w) for i, _, w in jremoved] == [(1, 0.0)]
    assert len(t) == 2
    params = t.stacked_params()
    back = td.MixtureDensity.from_params(params)
    np.testing.assert_allclose(back.weights, t.weights, rtol=RTOL64)
    moved = core.MixtureParams(**{**{f: getattr(params, f) for f in core._FIELDS},
                                  "means": params.means + 1.0})
    t.set_params(moved)
    np.testing.assert_allclose(t.components[0].mu, np.asarray(params.means[0]) + 1.0)
    means, covs, dofs, weights = td.recover_t_mixture(t)
    jmeans, jcovs, jdofs, jweights = jd.recover_t_mixture(j)
    np.testing.assert_allclose(covs, jcovs, rtol=RTOL64)
    np.testing.assert_allclose(dofs, jdofs)
    np.testing.assert_allclose(weights, jweights)


@pytest.mark.parametrize("student_t", [False, True])
def test_params_from_numpy_takes_a_jax_mixture(student_t):
    """A JAX MixtureDensity converts to the port's stacked parameters and
    back to a port MixtureDensity."""
    t, j = mixtures(student_t)
    params = core.params_from_numpy(j)
    for f, v in core.params_to_numpy(params).items():
        ref = getattr(j.stacked_params(jnp.float64), f)
        if v is not None:
            np.testing.assert_allclose(v, np.asarray(ref), rtol=RTOL64, atol=ATOL64, err_msg=f)
    mix = td.MixtureDensity.from_params(params)
    x = points()
    np.testing.assert_allclose(mix.multi_evaluate(x), j.multi_evaluate(x), rtol=RTOL64,
                               atol=ATOL64)


def test_mixture_numpy_draws_match_jax():
    """The reference's multinomial block allocation with a numpy generator:
    identical samples and trace in both packages."""
    t, j = mixtures(False)
    np.testing.assert_allclose(t.propose(300, np.random.RandomState(5)),
                               j.propose(300, np.random.RandomState(5)), rtol=RTOL64)
    xt, lt = t.propose(300, np.random.RandomState(6), trace=True, shuffle=False)
    xj, lj = j.propose(300, np.random.RandomState(6), trace=True, shuffle=False)
    np.testing.assert_allclose(xt, xj, rtol=RTOL64)
    np.testing.assert_array_equal(lt, lj)
    with pytest.raises(ValueError):
        t.propose(5, trace=True, shuffle=True)


@pytest.mark.parametrize("student_t", [False, True])
def test_mixture_torch_draws_in_distribution(student_t):
    t, _ = mixtures(student_t, weights=(1.0, 0.0, 2.0))
    n = 30000
    x, latent = t.propose(n, rng=21, trace=True, shuffle=False)
    assert x.shape == (n, 3) and np.all(latent != 1)      # a dead component is never drawn
    np.testing.assert_allclose(np.bincount(latent, minlength=3) / n, t.weights, atol=0.02)
    means = np.array([c.mu for c in t.components])
    assert np.all(np.abs(x.mean(0) - t.weights @ means) < 0.1)
